"""Launch and batch planning for the CUDA coding kernels.

What the port keeps of `repro.kernels.autotune`:

  * `TilePlan` — one launch decision, as the kernel's host code makes it.
    `matmul_plan` describes `gf_matmul_sm90_kernel`
    (`csrc/gf_matmul_sm90.cu`): 384 threads (a producer and two consumer
    warpgroups), a persistent grid of min(tiles, SMs) CTAs walking
    128-byte tiles of each stripe, the output in N tiles of at most 30
    rows at one instantiated width, the contraction in as few K passes as
    fit the bit matrix and a 3-stage data ring in 232,448 B of shared
    memory. `kernel_plan` is that tiling alone; its constants mirror the
    C++ ones, each beside the line it copies, and a card test holds both
    to the host's own plan (`repro_gf_plan`). `xor_plan` describes
    `xor_fold_kernel` (`csrc/coding_kernels.cu`): 256 threads, 16 bytes a
    thread, a grid-stride loop over at most 1024 blocks.
  * `plan_stream_windows` — the stripe window of the streamed write,
    which plans host memory only.
  * the measured-timings cache's JSON format,

        {"version": 1,
         "entries": {"gfmm:k=180:m=30:B=1048576":
                         {"block_b": 128, "seconds": 0.00356}, ...}}

    read from the file named by `REPRO_TORCH_AUTOTUNE_CACHE` (its own
    variable: the reference's entries are TPU tiles). Nothing reads the
    entries yet; measured tuning of the launch shape is ROADMAP A5.

The TPU VMEM budget model is gone: Hopper's limit is the shared memory a
block may use, which the K passes are sized to.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_TIMINGS_VERSION = 1

# xor_fold_kernel (csrc/coding_kernels.cu)
THREADS = 256                    # kThreads, coding_kernels.cu:25
BYTES_PER_THREAD = 16            # one 16-byte vector per thread
MAX_GRID_X = 1024                # kMaxGridX, coding_kernels.cu:26

# gf_matmul_sm90_kernel (csrc/gf_matmul_sm90.cu)
GF_TILE = 128                    # kTile, gf_matmul_sm90.cu:91
GF_THREADS = 384                 # kThreads, :92
STAGES = 3                       # kStages, :93
MAX_STEPS = 64                   # kMaxSteps, :94 (32-column steps a pass)
SMEM_LIMIT = 232_448             # kSmemLimit, :95
BAR_BYTES = 64                   # kBarBytes, :96
WIDTHS = (32, 64, 128, 176, 240)  # kWidths, :98 (N = 8 x output rows)
H100_SMS = 132                   # SMs of the H100 SXM: the default grid cap


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch decision along the byte dimension.

    `block_b` is the bytes one block covers per step (a GF tile, or a
    grid-stride step of the XOR kernel), `padded` the bytes the launch
    spans (the kernels mask the ragged tail, so `pad` is always 0),
    `grid_steps` the blocks launched (the GF kernel's persistent grid),
    `smem_bytes` the dynamic shared memory of one block and `threads` its
    threads. For the GF kernel, `passes` is its K passes and `n_width`
    its instantiated N (1 and 0 for the XOR kernel)."""
    block_b: int
    padded: int
    pad: int
    grid_steps: int
    smem_bytes: int
    threads: int
    passes: int = 1
    n_width: int = 0
    source: str = "fixed"


def _round1024(x: int) -> int:
    return -(-x // 1024) * 1024


def kernel_plan(m: int, k: int) -> dict:
    """How `gf_matmul_sm90_kernel` cuts an (m, k) product, as the host's
    `make_plan` (gf_matmul_sm90.cu:585) works it out: 32 bit columns (4
    data rows) a step, N tiles of at most 30 output rows at the narrowest
    instantiated width that holds them, and as few K passes as fit the
    bit matrix of a pass and the data ring in `SMEM_LIMIT`."""
    ksteps = -(-k // 4)
    nnt = -(-m // (WIDTHS[-1] // 8))
    rows = -(-m // nnt)
    nnt = -(-m // rows)
    N = next(n for n in WIDTHS if 8 * rows <= n)
    npk = -(-ksteps // MAX_STEPS)
    while True:
        spp = -(-ksteps // npk)
        smem = 1024 + _round1024(spp * N * 32) + STAGES * _round1024(
            4 * spp * GF_TILE) + BAR_BYTES
        if smem <= SMEM_LIMIT:
            return dict(N=N, n_tiles=nnt, rows_per_tile=rows, k_passes=npk,
                        steps_per_pass=spp, smem=smem)
        npk += 1


def matmul_plan(k: int, m: int, B: int, *, S: int = 1,
                sms: int = H100_SMS) -> TilePlan:
    """Launch shape of `gf_bitmatmul` for an (m, k) matrix over S stripes
    of B bytes on a card with `sms` SMs."""
    plan = kernel_plan(m, k)
    tiles = S * -(-B // GF_TILE)
    return TilePlan(block_b=GF_TILE, padded=B, pad=0,
                    grid_steps=min(tiles, sms), smem_bytes=plan["smem"],
                    threads=GF_THREADS, passes=plan["k_passes"],
                    n_width=plan["N"])


def xor_plan(s: int, B: int) -> TilePlan:
    """Launch shape of `xor_reduce` for s sources over B bytes."""
    chunks = -(-max(B, 1) // BYTES_PER_THREAD)
    return TilePlan(block_b=THREADS * BYTES_PER_THREAD, padded=B, pad=0,
                    grid_steps=min(MAX_GRID_X, -(-chunks // THREADS)),
                    smem_bytes=0, threads=THREADS)


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
