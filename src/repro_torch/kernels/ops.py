"""Public wrappers around the coding kernels (port of `repro.kernels.ops`).

API (all uint8 byte tensors; the result lies on the input's device):
  encode(code, data)            -> codeword                (gf_bitmatmul)
  apply_matrix(M, blocks)       -> GF matmul on blocks     (gf_bitmatmul)
  xor_fold(blocks)              -> XOR of blocks           (xor_reduce)
  recover_single(plan, blocks)  -> one block               (xor path if plan
                                                            is XOR-only)

Stripe-batched variants (leading S axis, ONE kernel launch per call):
  encode_many(code, data)       -> (S, k, B) -> (S, n, B)
  apply_matrix_many(M, blocks)  -> (S, k, B) -> (S, m, B)
  xor_fold_many(blocks)         -> (S, s, B) -> (S, B)
  recover_many(plan, blocks)    -> {src: (S, B)} -> (S, B)
  apply_decode_many(plan, blocks) -> {src: (S, B)} -> {erased: (S, B)}

Shapes, dispatch rules and bytes are the reference's. A CUDA tensor goes
through the CUDA kernel; a CPU tensor through the kernel's plain PyTorch
version; anything else raises.

KERNEL_LAUNCHES counts calls per kernel name ("gf_bitmatmul",
"xor_reduce") exactly where the reference counts its Pallas launches, on
either device, so launch bounds carry over: one launch per erasure
pattern, ceil(S / window) for a streamed write. All mutation goes through
`_count_launch` under a lock; `launch_scope()` gives a caller a
thread-local delta counter. The kernel modules' own `launches` counters
count only real CUDA launches.

Every launch is planned, as the reference's ops plan their tiles
(`autotune.plan_matmul_tiles` / `plan_xor_tiles`): a measured plan's grid
is passed to the kernel where `REPRO_TORCH_AUTOTUNE_CACHE` names timings
for the shape, and otherwise no grid, so the kernel takes its own
default.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
from collections.abc import Iterator

import numpy as np
import torch

from repro_torch.core.codec import DecodePlan, RecoveryPlan
from repro_torch.core.codes import Code
from repro_torch.core.gf import gf_bit_columns

from .autotune import device_sms, plan_matmul_tiles, plan_xor_tiles
from .gf_bitmatmul import gf_bitmatmul, resident_ctas
from .xor_reduce import xor_reduce

KERNEL_LAUNCHES: collections.Counter = collections.Counter()
_LAUNCH_LOCK = threading.Lock()
_LAUNCH_SCOPES = threading.local()      # per-thread stack of LaunchScope


class LaunchScope:
    """Thread-local launch delta: counts launches issued by the current
    thread while the scope is active. Live-updating."""

    __slots__ = ("counts",)

    def __init__(self) -> None:
        self.counts: collections.Counter = collections.Counter()

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def _scope_stack() -> list[LaunchScope]:
    stack = getattr(_LAUNCH_SCOPES, "stack", None)
    if stack is None:
        stack = _LAUNCH_SCOPES.stack = []
    return stack


@contextlib.contextmanager
def launch_scope() -> Iterator[LaunchScope]:
    """Attribute kernel launches to the current thread: every launch this
    thread issues inside the scope is counted on the yielded
    `LaunchScope` (and still on KERNEL_LAUNCHES). Scopes nest; launches
    from other threads never leak in."""
    scope = LaunchScope()
    stack = _scope_stack()
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.remove(scope)


def _count_launch(name: str) -> None:
    """The one mutation point for launch accounting: global counter under
    the lock, plus every active scope of the calling thread."""
    with _LAUNCH_LOCK:
        KERNEL_LAUNCHES[name] += 1      # repro-lint: allow=RA007
    for scope in _scope_stack():
        scope.counts[name] += 1


def reset_kernel_launch_counts() -> None:
    with _LAUNCH_LOCK:
        KERNEL_LAUNCHES.clear()         # repro-lint: allow=RA007


def kernel_launch_snapshot() -> dict[str, int]:
    """Point-in-time copy of KERNEL_LAUNCHES (single-threaded deltas;
    use `launch_scope()` under concurrency)."""
    with _LAUNCH_LOCK:
        return dict(KERNEL_LAUNCHES)


def launches_since(snapshot: dict[str, int]) -> int:
    """Total launches since `snapshot` (see kernel_launch_snapshot)."""
    with _LAUNCH_LOCK:
        total = sum(KERNEL_LAUNCHES.values())
    return total - sum(snapshot.values())


@functools.lru_cache(maxsize=64)
def _cols_for(A_bytes: bytes, shape: tuple, device: torch.device
              ) -> torch.Tensor:
    A = np.frombuffer(A_bytes, dtype=np.uint8).reshape(shape)
    return torch.from_numpy(gf_bit_columns(A)).to(device)


def _cols(M: np.ndarray, device: torch.device) -> torch.Tensor:
    """Bit columns of M on `device`, uploaded once per matrix content."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    return _cols_for(M.tobytes(), M.shape, device)


def _u8(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    return x


def _gf(M: np.ndarray, blocks: torch.Tensor) -> torch.Tensor:
    """One planned launch of the GF kernel: (S, k, B) -> (S, m, B)."""
    cols = _cols(M, blocks.device)
    S, k, B = blocks.shape
    m = cols.shape[0]
    plan = plan_matmul_tiles(k, m, B, S=S, sms=device_sms(blocks.device),
                             resident=resident_ctas(m, k, blocks.device))
    _count_launch("gf_bitmatmul")
    return gf_bitmatmul(cols, blocks.contiguous(), grid=_grid(plan))


def _xor(blocks: torch.Tensor) -> torch.Tensor:
    """One planned launch of the XOR kernel: (S, s, B) -> (S, B)."""
    S, s, B = blocks.shape
    plan = plan_xor_tiles(s, B, S=S)
    _count_launch("xor_reduce")
    return xor_reduce(blocks.contiguous(), grid=_grid(plan))


def _grid(plan) -> int | None:
    """A measured plan's grid; None (the kernel's own default, which the
    model's plan describes) otherwise."""
    return plan.grid_steps if plan.source == "measured" else None


def apply_matrix(M: np.ndarray, blocks: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul M (m, k) @ blocks (k, B) -> (m, B)."""
    return _gf(M, _u8(blocks)[None])[0]


def apply_matrix_many(M: np.ndarray, blocks: torch.Tensor) -> torch.Tensor:
    """Stripe-batched GF(2^8) matmul: M (m, k) @ blocks (S, k, B) ->
    (S, m, B), one launch for the whole batch."""
    return _gf(M, _u8(blocks))


def encode(code: Code, data: torch.Tensor) -> torch.Tensor:
    """data (k, B) uint8 -> full codeword (n, B): [data | parities]."""
    parity = apply_matrix(code.A, data)
    return torch.cat([data, parity], dim=0)


def encode_many(code: Code, data: torch.Tensor) -> torch.Tensor:
    """data (S, k, B) uint8 -> (S, n, B) codewords, ONE kernel launch."""
    parity = apply_matrix_many(code.A, data)
    return torch.cat([data, parity], dim=1)


def xor_fold(blocks: torch.Tensor) -> torch.Tensor:
    """(s, B) uint8 -> (B,) uint8 XOR-fold."""
    return _xor(_u8(blocks)[None])[0]


def xor_fold_many(blocks: torch.Tensor) -> torch.Tensor:
    """(S, s, B) uint8 -> (S, B) uint8 XOR-fold along axis 1, one launch."""
    return _xor(_u8(blocks))


def _stack(blocks: dict[int, torch.Tensor], sources, dim: int
           ) -> torch.Tensor:
    return torch.stack([_u8(blocks[s]) for s in sources], dim=dim)


def _xor_row(M: np.ndarray) -> bool:
    """A one-target plan whose coefficients are all 0/1: an XOR fold."""
    return M.shape[0] == 1 and bool(np.all((M == 0) | (M == 1)))


def recover_single(plan: RecoveryPlan, blocks: dict[int, torch.Tensor]
                   ) -> torch.Tensor:
    """Execute a single-failure recovery plan: XOR-only plans (every
    UniLRC recovery — Property 2) fold; mixed coefficients multiply."""
    src = _stack(blocks, plan.sources, 0)
    if plan.xor_only:
        return xor_fold(src)
    M = np.array([plan.coeffs], dtype=np.uint8)       # (1, s)
    return apply_matrix(M, src)[0]


def apply_decode(plan: DecodePlan, blocks: dict[int, torch.Tensor]
                 ) -> dict[int, torch.Tensor]:
    """Execute a multi-erasure decode plan."""
    if not plan.erased:
        return {}
    src = _stack(blocks, plan.sources, 0)
    if _xor_row(plan.M):
        sel = src[torch.from_numpy(np.flatnonzero(plan.M[0])).to(src.device)]
        return {plan.erased[0]: xor_fold(sel)}
    rec = apply_matrix(plan.M, src)
    return {e: rec[i] for i, e in enumerate(plan.erased)}


def recover_many(plan: RecoveryPlan, blocks: dict[int, torch.Tensor]
                 ) -> torch.Tensor:
    """Execute one single-failure plan across S stripes in ONE launch.

    blocks: {source block id -> (S, B) uint8}. Returns (S, B)."""
    src = _stack(blocks, plan.sources, 1)                   # (S, s, B)
    if plan.xor_only:
        return xor_fold_many(src)
    M = np.array([plan.coeffs], dtype=np.uint8)            # (1, s)
    return apply_matrix_many(M, src)[:, 0]


def apply_decode_many(plan: DecodePlan, blocks: dict[int, torch.Tensor]
                      ) -> dict[int, torch.Tensor]:
    """Execute one multi-erasure decode plan across S stripes in one
    launch. blocks: {source block id -> (S, B)}; returns {erased: (S, B)}."""
    if not plan.erased:
        return {}
    if _xor_row(plan.M):
        sel = [plan.sources[i] for i in np.flatnonzero(plan.M[0])]
        return {plan.erased[0]: xor_fold_many(_stack(blocks, sel, 1))}
    rec = apply_matrix_many(plan.M, _stack(blocks, plan.sources, 1))
    return {e: rec[:, i] for i, e in enumerate(plan.erased)}
