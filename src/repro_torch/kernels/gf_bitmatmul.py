"""GF(2^8) coding matmul — encode, multi-erasure decode, recovery plans
that are not XOR-only, and the parity terms of a delta update.

Port of the Pallas kernels `repro.kernels.gf_bitmatmul.gf_bitmatmul` and
`gf_bitmatmul_batched`: one CUDA kernel (`csrc/gf_matmul_sm90.cu`,
`gf_matmul_sm90_kernel`) computes (S, m, B) = A (m, k) @ (S, k, B) over
GF(2^8) in one launch; the unbatched form is S = 1.

The kernel runs the reference's bit-plane product on the int8 tensor
cores: parity_bits = (A_bits . data_bits) mod 2, transposed so that the
data bits are the `wgmma`'s register operand (64 byte positions x 32 bit
columns per instruction, each lane expanding whole data bytes) and the
bit matrix its shared-memory operand, written by the kernel from `cols`
(`cols[i, j, b] = A[i, j] * 2^b`, `core.gf.gf_bit_columns`: row 8i+o,
column 8j+b of `A_bits` is bit o of that byte). Where the bit matrix does
not fit in shared memory the contraction runs in passes over the same
byte tiles, each XORing its parity into the output
(`autotune.kernel_plan`, re-exported here).

The kernel reads data rows through 16-byte strides from a 16-byte-aligned
base. A tensor whose width B is not a multiple of 16, or whose base is not
aligned, is first copied into rows of pitch B rounded up to 16: a route
taken by shape, after which the same kernel runs.

`gf_bitmatmul` is the wrapper: a CUDA tensor launches the kernel (counted
in `launches`), a CPU tensor takes `gf_bitmatmul_plain` (counted in
`plain_calls`). There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from .autotune import SMEM_LIMIT, kernel_plan  # noqa: F401

launches = 0        # CUDA kernel launches
plain_calls = 0     # plain-PyTorch evaluations (CPU tensors)
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global launches, plain_calls
    with _COUNT_LOCK:
        launches = plain_calls = 0


def gf_bitmatmul_plain(cols: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """cols (m, k, 8), data (S, k, B) uint8 -> (S, m, B) uint8, in plain
    PyTorch: out[s, i] = XOR over j, b of cols[i, j, b] where bit b of
    data[s, j] is set."""
    m, k, _ = cols.shape
    S, _, B = data.shape
    out = torch.zeros((S, m, B), dtype=torch.uint8, device=data.device)
    for j in range(k):
        x = data[:, j]                                        # (S, B)
        for b in range(8):
            mask = ((x >> b) & 1).mul_(255)                   # 0x00 / 0xFF
            out ^= mask[:, None, :] & cols[None, :, j, b, None]
    return out


def bound_bytes(S: int, m: int, k: int, B: int) -> int:
    """Bytes the product must move: data read once, output written once
    (the coefficients are m * k * 8 bytes, negligible at these widths)."""
    return S * (k + m) * B + m * k * 8


def bound_ops(S: int, m: int, k: int, B: int) -> int:
    """int8 operations of the bit-plane product: 2 * 8m * 8k per column."""
    return 2 * (8 * m) * (8 * k) * B * S


def pass_bytes(S: int, m: int, k: int, B: int) -> int:
    """Bytes the kernel moves beyond `bound_bytes`: every K pass after the
    first reads and rewrites the output, every N tile after the first
    reads the data again."""
    plan = kernel_plan(m, k)
    return (2 * S * m * B * (plan["k_passes"] - 1)
            + S * k * B * (plan["n_tiles"] - 1))


_PLAN_FIELDS = ("threads", "grid", "smem", "N", "n_tiles", "k_passes",
                "steps_per_pass", "rows_per_tile", "resident")


def host_plan(S: int, m: int, k: int, B: int, grid: int | None = None
              ) -> dict:
    """The plan `repro_gf_matmul` would launch on the current CUDA device
    for this shape and `grid` (None: the persistent default), from the
    host code itself (`repro_gf_plan`), without launching: threads, grid,
    dynamic shared memory, the tiling of `kernel_plan`, and the CTAs one
    SM holds at once by the occupancy calculator (shared memory, threads
    and registers: the grid's ceiling is that times the SMs). Raises for
    a grid the launch would refuse."""
    out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    g = _build.grid_arg(grid, "gf_bitmatmul")
    _build.check(_build.library().repro_gf_plan(S, m, k, B, g, out),
                 "gf_plan")
    return dict(zip(_PLAN_FIELDS, out))


@functools.lru_cache(maxsize=256)
def _resident(m: int, k: int, index: int) -> int:
    with _build.device_guard(torch.device("cuda", index)):
        return host_plan(1, m, k, 1)["resident"]


def resident_ctas(m: int, k: int, device) -> int:
    """CTAs of the kernel that one SM of `device` holds at once for an
    (m, k) product (`host_plan`'s `resident`, which depends on the matrix
    alone), asked of the host code once per shape and card; 1 off the
    card, where the plain version takes no grid."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _resident(m, k, index)


def _check(cols: torch.Tensor, data: torch.Tensor) -> None:
    if cols.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(f"gf_bitmatmul takes uint8, got {cols.dtype}, "
                        f"{data.dtype}")
    if cols.dim() != 3 or cols.shape[2] != 8 or data.dim() != 3:
        raise ValueError(f"gf_bitmatmul takes cols (m, k, 8) and data "
                         f"(S, k, B), got {tuple(cols.shape)}, "
                         f"{tuple(data.shape)}")
    m, k, _ = cols.shape
    S, kk, _B = data.shape
    if kk != k:
        raise ValueError(f"cols have k={k}, data has {kk} rows")
    if m < 1 or k < 1 or not 1 <= S <= 65535:
        raise ValueError(f"gf_bitmatmul needs m, k >= 1 and 1 <= S <= 65535,"
                         f" got S={S}, m={m}, k={k}")
    if cols.device != data.device:
        raise ValueError(f"cols on {cols.device}, data on {data.device}")


def gf_bitmatmul(cols: torch.Tensor, data: torch.Tensor,
                 grid: int | None = None) -> torch.Tensor:
    """(S, m, B) = A @ data over GF(2^8), one launch for all S stripes.

    cols: (m, k, 8) uint8 bit columns of A (`core.gf.gf_bit_columns`).
    data: (S, k, B) uint8. grid: the CTAs to launch (None: the persistent
    default, min(tiles, SMs); `autotune.plan_matmul_tiles` plans it); the
    launch raises for a grid past the tiles or past what the SMs hold
    (`host_plan`). The plain version computes the same bytes whatever
    the grid."""
    global launches, plain_calls
    _check(cols, data)
    g = _build.grid_arg(grid, "gf_bitmatmul")
    m, k, _ = cols.shape
    S, _, B = data.shape
    if data.device.type == "cpu":
        with _COUNT_LOCK:
            plain_calls += 1
        return gf_bitmatmul_plain(cols, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_bitmatmul runs on cuda or cpu, got {data.device}")
    if not (cols.is_contiguous() and data.is_contiguous()):
        raise ValueError("gf_bitmatmul needs contiguous cols and data")
    if cols.data_ptr() % 8:
        raise ValueError("gf_bitmatmul needs 8-byte aligned cols")
    out = torch.empty((S, m, B), dtype=torch.uint8, device=data.device)
    if B == 0:
        return out
    if B % 16 or data.data_ptr() % 16:
        # rows of pitch B rounded up to 16 from an aligned base (module
        # docstring); the pad bytes are never read
        aligned = torch.empty((S, k, -(-B // 16) * 16), dtype=torch.uint8,
                              device=data.device)
        aligned[:, :, :B] = data
        data = aligned
    lib = _build.library()
    stream = _build.stream_handle(data.device)
    with _build.device_guard(data.device):
        err = lib.repro_gf_matmul(cols.data_ptr(), data.data_ptr(),
                                  out.data_ptr(), S, m, k, B, g, stream)
    _build.check(err, "gf_matmul")
    with _COUNT_LOCK:
        launches += 1
    return out
