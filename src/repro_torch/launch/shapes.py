"""Assigned input shapes x architecture cell enumeration (port of
`repro.launch.shapes`, over `repro_torch.configs`).

Four LM shapes (the assignment):
  train_4k     seq 4096  x global_batch 256   -> train_step
  prefill_32k  seq 32768 x global_batch 32    -> serve_prefill
  decode_32k   one token, KV cache 32768, batch 128 -> serve_decode
  long_500k    one token, 524288 context, batch 1   -> serve_decode
               (sub-quadratic archs only)

Skips:
  * long_500k for full-attention archs (quadratic attention: not runnable),
  * decode shapes for encoder-only (hubert has no autoregressive decode).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import all_archs, get_config


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(arch: str, shape: str) -> str:
    """'run' or a skip reason."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if spec.kind == "decode" and not cfg.has_decode:
        return "skip: encoder-only, no autoregressive decode"
    if shape == "long_500k" and not cfg.subquadratic:
        return "skip: full attention is quadratic at 524288 tokens"
    return "run"


def all_cells() -> list[tuple[str, str, str]]:
    """[(arch, shape, status)]: all 40 nominal cells."""
    return [(a, s, cell_status(a, s))
            for a in all_archs() for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s, st in all_cells() if st == "run"]
