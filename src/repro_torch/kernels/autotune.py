"""Launch and batch planning for the CUDA coding kernels.

What the port keeps of `repro.kernels.autotune`:

  * `TilePlan` — one launch decision along the byte dimension. The CUDA
    kernels fix their own configuration for now (16 bytes a thread,
    256 threads a block, a grid-stride loop over at most 1024 blocks
    along B, 16 output rows a block for the GF matmul); `matmul_plan` and
    `xor_plan` report it in this form.
  * `plan_stream_windows` — the stripe window of the streamed write,
    which plans host memory only.
  * the measured-timings cache's JSON format,

        {"version": 1,
         "entries": {"gfmm:k=180:m=30:B=1048576":
                         {"block_b": 4096, "seconds": 0.00213}, ...}}

    read from the file named by `REPRO_TORCH_AUTOTUNE_CACHE` (its own
    variable: the reference's entries are TPU tiles). Nothing reads the
    entries yet; measured tuning of the CUDA launch shape comes with the
    work that makes the kernels fast.

The TPU VMEM budget model is gone: Hopper's limit is the 227 KB of
shared memory a block may use, and the GF kernel's coefficient stage
(k * 16 * 8 bytes, 23,040 B at k = 180) stays far below it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

THREADS = 256                    # threads per block (csrc kThreads)
BYTES_PER_THREAD = 16            # one 16-byte vector per thread
ROWS_PER_BLOCK = 16              # GF output rows per block (kRowsPerBlock)
MAX_GRID_X = 1024                # blocks along B; a grid-stride loop covers the rest
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_TIMINGS_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch decision along the byte dimension.

    `block_b` is the bytes one block covers per grid-stride step,
    `padded` the bytes the launch spans (the kernels mask the ragged
    tail, so `pad` is always 0), `grid_steps` the blocks along B, and
    `smem_bytes` the dynamic shared memory of one block."""
    block_b: int
    padded: int
    pad: int
    grid_steps: int
    smem_bytes: int
    source: str = "fixed"


def _grid_x(B: int) -> int:
    chunks = -(-max(B, 1) // BYTES_PER_THREAD)
    return min(MAX_GRID_X, -(-chunks // THREADS))


def matmul_plan(k: int, m: int, B: int) -> TilePlan:
    """Launch shape of `gf_bitmatmul` for an (m, k) matrix over B bytes."""
    return TilePlan(block_b=THREADS * BYTES_PER_THREAD, padded=B, pad=0,
                    grid_steps=_grid_x(B), smem_bytes=k * ROWS_PER_BLOCK * 8)


def xor_plan(s: int, B: int) -> TilePlan:
    """Launch shape of `xor_reduce` for s sources over B bytes."""
    return TilePlan(block_b=THREADS * BYTES_PER_THREAD, padded=B, pad=0,
                    grid_steps=_grid_x(B), smem_bytes=0)


def plan_stream_windows(k: int, n: int, block_size: int, *,
                        host_budget_bytes: int = 1 << 31,
                        cap: int = 64) -> int:
    """Stripe-batch window for the streaming checkpoint write path.

    The double-buffered pipeline holds at most TWO windows of (n,
    block_size) codewords plus one (k, block_size) input view per
    stripe; pick the largest window (<= cap, the engine's
    max_batch_stripes default) whose staging fits `host_budget_bytes`
    of host memory. Always >= 1."""
    per_stripe = (2 * n + k) * block_size
    return max(1, min(cap, host_budget_bytes // max(per_stripe, 1)))


# -- measured-timings cache ---------------------------------------------------

def timings_path() -> pathlib.Path | None:
    """The persisted-timings file, or None when no file is named."""
    p = os.environ.get(CACHE_ENV)
    return pathlib.Path(p) if p else None


def load_timings(path: pathlib.Path | None = None) -> dict[str, dict]:
    """Measured entries from `path` (default: the env-pointed file);
    {} when absent, unreadable, or version-mismatched."""
    path = path or timings_path()
    if path is None or not path.exists():
        return {}
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != _TIMINGS_VERSION:
        return {}
    entries = doc.get("entries", {})
    return entries if isinstance(entries, dict) else {}


def save_timings(entries: dict[str, dict],
                 path: pathlib.Path | None = None) -> pathlib.Path:
    """Merge `entries` into the timings file (creating it) and return its
    path. Raises ValueError when no path is given and the env var is
    unset — persisting measurements is always an explicit ask."""
    path = path or timings_path()
    if path is None:
        raise ValueError(f"no timings path: pass path= or set {CACHE_ENV}")
    merged = load_timings(path)
    merged.update(entries)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"version": _TIMINGS_VERSION, "entries": merged}, indent=2))
    return path


def matmul_key(k: int, m: int, B: int) -> str:
    return f"gfmm:k={k}:m={m}:B={B}"


def xor_key(s: int, nbytes: int) -> str:
    return f"xor:s={s}:bytes={nbytes}"
