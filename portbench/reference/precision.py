"""Number formats the plain reference computes in.

`FP32` is the reference itself: every operand in float32, TF32 off.
`FP8` is the control: the reference with every matmul operand (weights,
activations, attention's q, k and v) rounded to float8 e4m3 under a
per-tensor scale, as an fp8 deployment computes, the products still
accumulated in float32. It is the step below the bfloat16 that the
configurations state.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class Precision:
    """How operands are rounded before a product (`op`)."""

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()


class Fp8(Precision):
    def op(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


FP32 = Precision()
FP8 = Fp8()


@contextlib.contextmanager
def full_fp32():
    """float32 products in float32: TF32 off for matmuls and cuDNN, the
    settings put back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
