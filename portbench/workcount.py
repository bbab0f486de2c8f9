"""Work counts of the benchmark: operations and bytes computed from shapes.

These are the yardstick's own copies, frozen here so that a change to the
program cannot change what its work is counted as. Every count is what the
inputs need, not what an implementation happens to do: causal pairs and not
the blocks a loop visits, real heads and not padded ones, each input read
once and each output written once. What one block kind's widths make of
that (`matmul_weights`, `attention_dims`) is counted in its own file,
`blocks/<kind>.py`.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
700 W limit.
"""
from __future__ import annotations

from .inputs import block_module

PEAK_BF16_FLOPS = 989e12        # FLOP/s, bf16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12        # B/s, HBM3


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs one head keeps under a causal mask whose last
    query sees every key: query i (0-based, aligned to the end of the keys)
    sees keys 0 .. skv - sq + i."""
    off = skv - sq
    if off >= 0:
        return sq * off + sq * (sq + 1) // 2
    return sum(off + i + 1 for i in range(sq) if off + i >= 0)


def attention_flops(batch: int, heads: int, sq: int, skv: int, dk: int,
                    dv: int, causal: bool = True) -> int:
    """The two products over the kept pairs: 2 * dk for a score, 2 * dv
    for its share of the output."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    return batch * heads * pairs * 2 * (dk + dv)


def attention_bytes(batch: int, heads: int, kv_heads: int, sq: int,
                    skv: int, dk: int, dv: int, itemsize: int = 2) -> int:
    """q, k and v read once, the output written once."""
    return itemsize * (batch * heads * sq * (dk + dv)
                       + batch * kv_heads * skv * (dk + dv))


def least_seconds(flops: int, nbytes: int) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def prefill_flops(block: str, c: dict, layers: int, batch: int,
                  prompt: int) -> int:
    """Model FLOPs of one prefill batch: two per matmul weight per prompt
    token in every block; causal attention pairs at the published head
    dims and real head count; the LM head for each prompt's last position
    only, the one the first token needs. The embedding is a gather and
    counts nothing."""
    kind = block_module(block)
    tokens = batch * prompt
    heads, _, dk, dv = kind.attention_dims(c)
    per_layer = (2 * kind.matmul_weights(c) * tokens
                 + attention_flops(batch, heads, prompt, prompt, dk, dv))
    head = 2 * c["hidden_size"] * c["vocab_size"] * batch
    return layers * per_layer + head
