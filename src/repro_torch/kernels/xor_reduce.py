"""XOR fold of s blocks — UniLRC's entire single-failure decode path (XOR
locality, paper §2.3.3/§4.1 Property 2) and the gateway pre-fold.

Port of the Pallas kernels `repro.kernels.xor_reduce.xor_reduce` and
`xor_reduce_batched`: one CUDA kernel (`csrc/coding_kernels.cu`,
`xor_fold_kernel`) folds (S, s, B) bytes to (S, B) in one launch; the
unbatched form is S = 1. It works on raw bytes, so a ragged B needs no
int32 lane view and no padding.

`xor_reduce` is the wrapper: a CUDA tensor launches the kernel (and counts
it in `launches`), a CPU tensor takes `xor_reduce_plain` (counted in
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


def xor_reduce_plain(blocks: torch.Tensor) -> torch.Tensor:
    """(S, s, B) uint8 -> (S, B) XOR along axis 1, in plain PyTorch."""
    out = blocks[:, 0].clone()
    for j in range(1, blocks.shape[1]):
        out ^= blocks[:, j]
    return out


def bound_bytes(S: int, s: int, B: int) -> int:
    """Bytes the fold must move: every input read once, the output once."""
    return (s + 1) * S * B


def _check(blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8:
        raise TypeError(f"xor_reduce takes uint8, got {blocks.dtype}")
    if blocks.dim() != 3:
        raise ValueError(f"xor_reduce takes (S, s, B), got {tuple(blocks.shape)}")
    S, s, _B = blocks.shape
    if s < 1 or not 1 <= S <= 65535:
        raise ValueError(f"xor_reduce needs s >= 1 and 1 <= S <= 65535, "
                         f"got S={S}, s={s}")


def xor_reduce(blocks: torch.Tensor) -> torch.Tensor:
    """(S, s, B) uint8 -> (S, B) uint8 XOR-fold along axis 1, one launch."""
    global launches, plain_calls
    _check(blocks)
    S, s, B = blocks.shape
    if blocks.device.type == "cpu":
        with _COUNT_LOCK:
            plain_calls += 1
        return xor_reduce_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"xor_reduce runs on cuda or cpu, got {blocks.device}")
    if not blocks.is_contiguous():
        raise ValueError("xor_reduce needs a contiguous (S, s, B) tensor")
    out = torch.empty((S, B), dtype=torch.uint8, device=blocks.device)
    if B == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    with torch.cuda.device(blocks.device):
        err = lib.repro_xor_fold(blocks.data_ptr(), out.data_ptr(),
                                 S, s, B, stream)
    _build.check(err, "xor_fold")
    with _COUNT_LOCK:
        launches += 1
    return out
