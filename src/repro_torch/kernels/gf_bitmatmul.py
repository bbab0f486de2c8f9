"""GF(2^8) coding matmul — encode, multi-erasure decode, recovery plans
that are not XOR-only, and the parity terms of a delta update.

Port of the Pallas kernels `repro.kernels.gf_bitmatmul.gf_bitmatmul` and
`gf_bitmatmul_batched`: one CUDA kernel (`csrc/coding_kernels.cu`,
`gf_matmul_kernel`) computes (S, m, B) = A (m, k) @ (S, k, B) over GF(2^8)
in one launch; the unbatched form is S = 1.

The TPU kernel multiplies the (8m, 8k) bit matrix `A_bits` by the data's
bit-planes on the MXU. The CUDA kernel takes the same bits packed one byte
per bit column, `cols[i, j, b] = A[i, j] * 2^b` (`core.gf.gf_bit_columns`:
row 8i+o, column 8j+b of `A_bits` is bit o of that byte), and computes
A[i, j] * x as the XOR of cols[i, j, b] over the set bits b of x.

`gf_bitmatmul` is the wrapper: a CUDA tensor launches the kernel (counted
in `launches`), a CPU tensor takes `gf_bitmatmul_plain` (counted in
`plain_calls`). There is no fallback from one to the other.
"""
from __future__ import annotations

import threading

import torch

from . import _build

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


def gf_bitmatmul(cols: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(S, m, B) = A @ data over GF(2^8), one launch for all S stripes.

    cols: (m, k, 8) uint8 bit columns of A (`core.gf.gf_bit_columns`).
    data: (S, k, B) uint8."""
    global launches, plain_calls
    _check(cols, data)
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
    lib = _build.library()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = lib.repro_gf_matmul(cols.data_ptr(), data.data_ptr(),
                                  out.data_ptr(), S, m, k, B, stream)
    _build.check(err, "gf_matmul")
    with _COUNT_LOCK:
        launches += 1
    return out
