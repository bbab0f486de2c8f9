"""Reference `attn_moe` block: grouped-query self-attention and a routed
mixture of SwiGLU experts, pre-norm with residuals, in float32.

Routing as the configuration states it: each token takes its top
`num_experts_per_tok` experts by softmax probability of the router, their
weights renormalised to sum 1; each prompt gives each expert
`capacity(S)` slots, filled by the tokens that chose it in order of
weight (equal weights in position order), and an expert drops the tokens
past its slots. A token's output is the weighted sum of its experts that
kept it.

Routing is discontinuous: a token whose router probabilities nearly tie
goes to one expert in bfloat16 and to another in float32, and on random
weights the hidden states grow alike across positions with depth, so such
switches compound. The layer can therefore follow another side's routing
decisions (which experts, which slots) and report how far those stand from
its own (`route`). Weights are `x @ W` matrices named as in
`portbench/blocks/attn_moe.py`. The cache is the rotated keys `k` and the
values `v`, (N, S, kv_heads x head_dim).
"""
from __future__ import annotations

import math

import torch

from .model import causal_attention, mm, rms_norm, rope, swiglu
from .precision import Precision


def capacity(c: dict, tokens: int) -> int:
    """Slots per (prompt, expert): the expected share times the capacity
    factor, rounded up to a multiple of 8 (at least 8), at most the
    prompt."""
    slots = math.ceil(tokens * c["num_experts_per_tok"]
                      / c["num_local_experts"] * c["capacity_factor"])
    return min(max(8, (slots + 7) // 8 * 8), tokens)


def route(h: torch.Tensor, router: torch.Tensor, c: dict, prec: Precision,
          follow: dict | None = None) -> tuple[torch.Tensor, dict, float]:
    """h (N, S, d) -> (gates (N, S, E): each token's renormalised weight at
    each expert that keeps it, 0 elsewhere; the decisions {"topi": (N, S,
    K) experts, "kept": (N, E, S) slots}; the gap).

    With `follow` (another side's decisions) the experts and slots are
    those, the weights this side's, and the gap is the widest margin by
    which a followed decision departs from what this side would decide:
    how far a followed expert's probability lies below this side's K-th
    best, and how far a kept token's weight lies below one its expert
    left out. Infinite where the followed slots cannot be this routing's
    (a slot for a token that did not choose the expert, or a count of
    slots other than min(capacity, tokens that chose it))."""
    _, s, _ = h.shape
    k, cap = c["num_experts_per_tok"], capacity(c, s)
    probs = torch.softmax(mm(h, router, prec), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topi = top.indices[..., :k] if follow is None else follow["topi"]
    sel = probs.gather(-1, topi)
    chosen = torch.zeros_like(probs).scatter(
        -1, topi, sel / sel.sum(-1, keepdim=True))
    # each expert's slots: its tokens by weight, ties in position order
    score = torch.where(chosen > 0, chosen, -1.0).transpose(1, 2)
    if follow is None:
        order = torch.sort(score, dim=-1, descending=True, stable=True).indices
        kept = torch.zeros_like(score, dtype=torch.bool)
        kept.scatter_(-1, order[..., :cap], True)
        kept &= score > 0
    else:
        kept = follow["kept"]
    gap = 0.0
    if follow is not None:
        gap = (top.values[..., k - 1] - sel.min(-1).values).max().item()
        cand = score > 0
        if (kept & ~cand).any() or not torch.equal(
                kept.sum(-1), cand.sum(-1).clamp_max(cap)):
            gap = float("inf")
        else:
            low = torch.where(kept, score, torch.inf).min(-1).values
            high = torch.where(cand & ~kept, score, -torch.inf).max(-1).values
            gap = max(gap, (high - low).max().item())
    gates = torch.where(kept, score, 0.0).transpose(1, 2)
    return gates, {"topi": topi, "kept": kept}, max(gap, 0.0)


def layer(x: torch.Tensor, w: dict, c: dict, prec: Precision,
          follow: dict | None = None
          ) -> tuple[torch.Tensor, dict, dict, float]:
    """x (N, S, d) float32 -> (x, {"k": (N, S, Hk x hd), "v": ...}, the
    routing decisions, their gap): see `route`."""
    n, s, d = x.shape
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    heads, kv_heads = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // heads

    h = rms_norm(x, w["norm1"], eps)
    q = rope(mm(h, w["q"], prec).view(n, s, heads, hd).transpose(1, 2),
             theta)
    k = rope(mm(h, w["k"], prec).view(n, s, kv_heads, hd).transpose(1, 2),
             theta)
    v = mm(h, w["v"], prec).view(n, s, kv_heads, hd).transpose(1, 2)
    out = torch.stack([causal_attention(q[i], k[i], v[i], hd ** -0.5, prec)
                       for i in range(n)])
    out = out.transpose(1, 2).reshape(n, s, heads * hd)
    x = x + mm(out, w["o"], prec)

    h = rms_norm(x, w["norm2"], eps)
    gates, decided, gap = route(h, w["router"], c, prec, follow)
    moe = torch.zeros_like(h)
    flat, hf = gates.reshape(n * s, -1), h.reshape(n * s, d)
    for e in range(flat.shape[1]):
        rows = torch.nonzero(flat[:, e] > 0).flatten()
        if rows.numel():
            y = swiglu(hf[rows], w["w1"][e], w["w3"][e], w["w2"][e], prec)
            moe.view(n * s, d).index_add_(0, rows, flat[rows, e, None] * y)
    x = x + moe
    cache = {"k": k.transpose(1, 2).reshape(n, s, kv_heads * hd),
             "v": v.transpose(1, 2).reshape(n, s, kv_heads * hd)}
    return x, cache, decided, gap
