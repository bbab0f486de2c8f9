"""Launch and batch planning for the CUDA coding kernels.

The port of `repro.kernels.autotune`:

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
  * `plan_matmul_tiles` / `plan_xor_tiles` — the plan `kernels/ops.py`
    launches by: the model's (`matmul_plan`, `xor_plan`, source "model")
    unless a measured timing applies (source "measured").
  * `measure_matmul_tiles` — times every candidate grid of one shape and
    returns the winner as a timings entry; `save_timings` persists it.
  * `plan_stream_windows` — the stripe window of the streamed write,
    which plans host memory only.

The tunable is the grid, not the TPU's lane tile: both kernels walk their
work grid-stride, so any grid of 1 or more is correct. The GF kernel's
candidates are SMs x c CTAs for c = 1 up to the CTAs one SM holds at once
(`resident`, which the host code's occupancy query reports:
`gf_bitmatmul.resident_ctas`), capped at the tiles: a grid past what the
SMs hold at once only queues CTAs behind others, and the host code
refuses it. Built with 168 registers a thread, the kernel holds one CTA
an SM, so on the H100 its only candidate is the default; the knob pays
once an instantiation with fewer registers exists. The XOR kernel's grid
width runs from 1 up to the blocks its bytes need; it has no measurer, as
the reference has none. Measured entries are read from the JSON file
named by `REPRO_TORCH_AUTOTUNE_CACHE` (its own variable: the reference's
entries are TPU tiles):

    {"version": 1,
     "entries": {"gfmm:k=1:m=21:B=1048576":
                     {"grid_steps": 132, "seconds": 6.1e-05,
                      "candidates": {"132": 6.1e-05}},
                 "xor:s=20:bytes=1048576": {"grid_steps": 128}}}

A planner clamps an entry's `grid_steps` into its range and ignores an
entry without a positive int there. Without the variable nothing is read
and every launch is the model's: `kernels/ops.py` then passes no grid, and
the kernels take their own default.

The TPU VMEM budget model is gone: Hopper's limit is the shared memory a
block may use, which the K passes are sized to.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import time

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_TIMINGS_VERSION = 1

# xor_fold_kernel (csrc/coding_kernels.cu)
THREADS = 256                    # kThreads, coding_kernels.cu:28
BYTES_PER_THREAD = 16            # one 16-byte vector per thread
MAX_GRID_X = 1024                # kMaxGridX, coding_kernels.cu:29

# gf_matmul_sm90_kernel (csrc/gf_matmul_sm90.cu)
GF_TILE = 128                    # kTile, gf_matmul_sm90.cu:93
GF_THREADS = 384                 # kThreads, :94
STAGES = 3                       # kStages, :95
MAX_STEPS = 64                   # kMaxSteps, :96 (32-column steps a pass)
SMEM_LIMIT = 232_448             # kSmemLimit, :97
BAR_BYTES = 64                   # kBarBytes, :98
WIDTHS = (32, 64, 128, 176, 240)  # kWidths, :100 (N = 8 x output rows)
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
    source: str = "model"


def _round1024(x: int) -> int:
    return -(-x // 1024) * 1024


def kernel_plan(m: int, k: int) -> dict:
    """How `gf_matmul_sm90_kernel` cuts an (m, k) product, as the host's
    `make_plan` (gf_matmul_sm90.cu:596) works it out: 32 bit columns (4
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


def xor_blocks(B: int) -> int:
    """Blocks of `THREADS` 16-byte chunks that B bytes need: the widest
    grid the XOR kernel takes."""
    return -(-(-(-max(B, 1) // BYTES_PER_THREAD)) // THREADS)


def xor_plan(s: int, B: int) -> TilePlan:
    """Launch shape of `xor_reduce` for s sources over B bytes."""
    return TilePlan(block_b=THREADS * BYTES_PER_THREAD, padded=B, pad=0,
                    grid_steps=min(MAX_GRID_X, xor_blocks(B)),
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
    invalidate_plan_cache()
    return path


def matmul_key(k: int, m: int, B: int) -> str:
    return f"gfmm:k={k}:m={m}:B={B}"


def xor_key(s: int, nbytes: int) -> str:
    return f"xor:s={s}:bytes={nbytes}"


@functools.lru_cache(maxsize=1)
def _timings() -> dict[str, dict]:
    return load_timings()


def invalidate_plan_cache() -> None:
    """Drop memoized plans and the loaded timings file (call after
    changing REPRO_TORCH_AUTOTUNE_CACHE or persisting new measurements)."""
    _timings.cache_clear()
    plan_matmul_tiles.cache_clear()
    plan_xor_tiles.cache_clear()


def _measured_grid(key: str, ceiling: int) -> int | None:
    """A measured entry's `grid_steps` clamped into [1, ceiling], or None
    where the entry is missing or malformed."""
    entry = _timings().get(key)
    if not isinstance(entry, dict):
        return None
    g = entry.get("grid_steps")
    if isinstance(g, bool) or not isinstance(g, int) or g < 1:
        return None
    return min(g, ceiling)


# -- planners -------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def plan_matmul_tiles(k: int, m: int, B: int, *, S: int = 1,
                      sms: int = H100_SMS, resident: int = 1) -> TilePlan:
    """The launch of an (m, k) GF product over S stripes of B bytes on a
    card with `sms` SMs, each holding `resident` CTAs of the kernel at
    once (`gf_bitmatmul.resident_ctas`): `matmul_plan`'s, with a measured
    grid where the timings file has one for `matmul_key(k, m, B)`,
    clamped to the tiles and to sms x resident."""
    plan = matmul_plan(k, m, B, S=S, sms=sms)
    tiles = S * -(-B // GF_TILE)
    g = _measured_grid(matmul_key(k, m, B), min(tiles, sms * resident))
    if g is None:
        return plan
    return dataclasses.replace(plan, grid_steps=g, source="measured")


@functools.lru_cache(maxsize=512)
def plan_xor_tiles(s: int, B: int, *, S: int = 1) -> TilePlan:
    """The launch of an s-source XOR fold of B bytes: `xor_plan`'s, with a
    measured grid width where the timings file has one for `xor_key(s, B)`
    (clamped to the blocks B needs). The width does not depend on the S
    stripes, which the grid's other axis takes."""
    plan = xor_plan(s, B)
    g = _measured_grid(xor_key(s, B), xor_blocks(B))
    if g is None:
        return plan
    return dataclasses.replace(plan, grid_steps=g, source="measured")


def matmul_candidates(k: int, m: int, B: int, *, S: int = 1,
                      sms: int = H100_SMS, resident: int = 1) -> list[int]:
    """The grids `measure_matmul_tiles` times: sms x c for c = 1 up to
    `resident`, the CTAs one SM holds at once, each capped at the tiles
    (so the default, min(tiles, sms), is always one)."""
    tiles = S * -(-B // GF_TILE)
    return sorted({min(sms * c, tiles) for c in range(1, resident + 1)})


def measure_matmul_tiles(k: int, m: int, B: int, *, S: int = 1,
                         repeat: int = 3, device="cuda",
                         sms: int | None = None,
                         resident: int | None = None) -> dict[str, dict]:
    """Time every candidate grid (`matmul_candidates`) of an (m, k) x S x B
    GF product through the kernel's wrapper and return the winner as a
    one-entry timings dict, `{matmul_key: {"grid_steps", "seconds",
    "candidates"}}`, to merge with `save_timings`. On a card each
    candidate's time is CUDA events around `repeat` launches queued back
    to back, after one warm-up launch; `sms` and `resident` default to the
    card's (`resident_ctas`). On the CPU the plain version runs (whatever
    the grid), timed on the host clock with `sms` H100_SMS and `resident`
    1 unless given, which tests the cache round trip and nothing of the
    card."""
    import torch

    from .gf_bitmatmul import gf_bitmatmul, resident_ctas

    device = torch.device(device)
    cuda = device.type == "cuda"
    if sms is None:
        sms = device_sms(device)
    if resident is None:
        resident = resident_ctas(m, k, device)
    gen = torch.Generator(device).manual_seed(0xEC)
    cols, data = (torch.randint(0, 256, shape, dtype=torch.uint8,
                                device=device, generator=gen)
                  for shape in ((m, k, 8), (S, k, B)))
    times = {}
    for g in matmul_candidates(k, m, B, S=S, sms=sms, resident=resident):
        gf_bitmatmul(cols, data, grid=g)                      # warm up
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(repeat):
                gf_bitmatmul(cols, data, grid=g)
            e1.record()
            e1.synchronize()
            times[g] = e0.elapsed_time(e1) / 1e3 / repeat
        else:
            t0 = time.perf_counter()
            for _ in range(repeat):
                gf_bitmatmul(cols, data, grid=g)
            times[g] = (time.perf_counter() - t0) / repeat
    best = min(times, key=times.get)
    return {matmul_key(k, m, B): {
        "grid_steps": best, "seconds": times[best],
        "candidates": {str(g): t for g, t in times.items()}}}


_SMS: dict[int, int] = {}


def device_sms(device) -> int:
    """The SMs of a CUDA device (cached per device index); `H100_SMS` for
    any other device, whose plain versions take no grid."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]
