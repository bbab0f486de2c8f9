"""int8 gradient compression for the cross-pod all-reduce (port of
`repro.optim.compress`).

Symmetric per-tensor quantisation, deterministic: round to nearest, ties
to even (`torch.round`, as `jnp.round`), clipped to [-127, 127], with one
fp32 scale per tensor travelling beside the int8 payload. Grads are a
dict or a sequence of tensors; the results have the same shape of
container.
"""
from __future__ import annotations

import torch


def _map(fn, grads):
    if isinstance(grads, dict):
        return {k: fn(v) for k, v in grads.items()}
    return type(grads)(fn(g) for g in grads)


def _quantise(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g32 = g.to(torch.float32)
    scale = torch.clamp(g32.abs().max() / 127.0, min=1e-12)
    ints = torch.clamp(torch.round(g32 / scale), -127, 127)
    return ints.to(torch.int8), scale


def compress_grads(grads):
    """fp32 / bf16 grads -> (int8 grads, fp32 scales)."""
    pairs = _map(_quantise, grads)
    return _map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs)


def decompress_grads(ints, scales):
    """int8 grads and their scales -> fp32 grads."""
    if isinstance(ints, dict):
        return {k: ints[k].to(torch.float32) * scales[k] for k in ints}
    return type(ints)(i.to(torch.float32) * s for i, s in zip(ints, scales))
