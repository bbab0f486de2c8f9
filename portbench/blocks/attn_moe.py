"""The `attn_moe` block kind's weights and how they go into the program.

`leaves` is the published layout (Phi-3.5-MoE's names: `q`, `k`, `v`, `o`,
the router, and experts `w1` gate, `w3` up, `w2` down, as `x @ W`
matrices) and how each leaf is drawn; `matmul_weights` and
`attention_dims` count the block's work at those widths. `load` hands
them to the port's `Block` (its `attn` and `moe` modules); ghost heads of
`tp_pad_heads`, if the head counts need them, are derived here.
`program_cache` reads one prompt's keys and values of one layer out of
the port's prefill cache, in the reference's layout. `TAP` names the
port's function whose calls carry its routing decisions, and `routing`
reads them, for the reference to follow
(`portbench/reference/attn_moe.py`).
"""
from __future__ import annotations

import torch

from . import padded

BF16, F32 = torch.bfloat16, torch.float32

#: The port's MoE calls `top_k` twice a layer: over each token's expert
#: probabilities (its K experts), then over each expert's tokens (its
#: slots, `moe_capacity` of them).
TAP = "repro_torch.models.layers:top_k"


def leaves(c: dict) -> list[tuple[str, tuple, torch.dtype, float | None]]:
    """(name, shape, dtype, std) of one layer's leaves; std None marks a
    norm scale, drawn as 1 + 0.1 N(0, 1). The router is float32, as the
    port serves it."""
    d, h, kv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    e, f = c["num_local_experts"], c["intermediate_size"]
    hd = d // h
    return [
        ("norm1", (d,), BF16, None),
        ("q", (d, h * hd), BF16, d ** -0.5),
        ("k", (d, kv * hd), BF16, d ** -0.5),
        ("v", (d, kv * hd), BF16, d ** -0.5),
        ("o", (h * hd, d), BF16, (h * hd) ** -0.5),
        ("norm2", (d,), BF16, None),
        ("router", (d, e), F32, d ** -0.5),
        ("w1", (e, d, f), BF16, d ** -0.5),
        ("w3", (e, d, f), BF16, d ** -0.5),
        ("w2", (e, f, d), BF16, f ** -0.5),
    ]


def matmul_weights(c: dict) -> int:
    """Matmul weights one token multiplies through in one block, at the
    published widths: q, k, v, o, the router and the
    `num_experts_per_tok` experts a token is routed to."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    hd, kv = d // h, c["num_key_value_heads"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    router = d * c["num_local_experts"]
    experts = c["num_experts_per_tok"] * 3 * d * c["intermediate_size"]
    return attn + router + experts


def attention_dims(c: dict) -> tuple[int, int, int, int]:
    """(query heads, key / value heads, dk, dv) at the published widths."""
    h = c["num_attention_heads"]
    hd = c["hidden_size"] // h
    return h, c["num_key_value_heads"], hd, hd


def check_port(cfg, c: dict) -> None:
    """The port's configuration has the published widths and the stated
    routing."""
    m = cfg.moe
    got = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.vocab_size, m.num_experts,
           m.num_experts_per_tok, m.d_ff_expert, m.capacity_factor,
           m.num_shared_experts, cfg.qkv_bias, cfg.rms_eps, cfg.rope_theta,
           cfg.tie_embeddings)
    want = (c["hidden_size"], c["num_attention_heads"],
            c["num_key_value_heads"],
            c["hidden_size"] // c["num_attention_heads"], c["vocab_size"],
            c["num_local_experts"], c["num_experts_per_tok"],
            c["intermediate_size"], c["capacity_factor"], 0, False,
            c["rms_norm_eps"], c["rope_theta"], c["tie_word_embeddings"])
    if got != want:
        raise SystemExit(f"the port's {cfg.name} has {got}, the benchmark's "
                         f"configuration {want}")


def load(block, w: dict, cfg, c: dict) -> None:
    """Set the parameters of the port's `attn_moe` block from the
    published leaves `w` (shared where the layouts agree)."""
    par = torch.nn.Parameter
    a, d = block.attn, c["hidden_size"]
    hd = d // c["num_attention_heads"]
    if (cfg.num_heads_padded != c["num_attention_heads"]
            and c["num_key_value_heads"] > 1):
        raise SystemExit("ghost heads regroup the query heads over the "
                         "kv heads: no published layout maps onto that")
    hq, hkv = cfg.num_heads_padded * hd, cfg.num_kv_heads_padded * hd
    a.wq = par(padded(w["q"], (d, hq)), requires_grad=False)
    a.wk = par(padded(w["k"], (d, hkv)), requires_grad=False)
    a.wv = par(padded(w["v"], (d, hkv)), requires_grad=False)
    a.wo = par(padded(w["o"], (hq, d)), requires_grad=False)
    moe = block.moe
    moe.router = par(w["router"], requires_grad=False)
    moe.w_gate = par(w["w1"], requires_grad=False)
    moe.w_up = par(w["w3"], requires_grad=False)
    moe.w_down = par(w["w2"], requires_grad=False)
    block.norm1 = par(w["norm1"], requires_grad=False)
    block.norm2 = par(w["norm2"], requires_grad=False)


def program_cache(leaf: dict, layer: int, row: int, c: dict) -> dict:
    """The port's cache {"k", "v": (L, B, Hk', S, hd)} (Hk' >= Hk with
    ghost heads) at one layer and batch row -> {"k", "v": (S, Hk x hd)},
    the real heads only."""
    def one(t: torch.Tensor) -> torch.Tensor:
        t = t[layer, row, :c["num_key_value_heads"]]         # (Hk, S, hd)
        return t.transpose(0, 1).reshape(t.shape[1], -1)
    return {name: one(leaf[name]) for name in ("k", "v")}


def routing(calls: list, c: dict, layers: int) -> list[dict] | None:
    """The port's routing decisions from the `TAP` calls of one prefill
    ((arguments, result) each, in order): per layer {"topi": (B, S, K),
    "kept": (B, E, S)}, as the reference names them; None if the calls
    are not two a layer of those shapes."""
    e, k = c["num_local_experts"], c["num_experts_per_tok"]
    if len(calls) != 2 * layers:
        return None
    out = []
    for (a1, (_, topi)), (a2, (gate, idx)) in zip(calls[::2], calls[1::2]):
        probs, score = a1[0], a2[0]
        if probs.shape[-1] != e or topi.shape[-1] != k or score.shape[1] != e:
            return None
        kept = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
        kept.scatter_(-1, idx, gate > 0)
        out.append({"topi": topi, "kept": kept})
    return out


def load_spread(routings: list[list[dict]], c: dict) -> dict:
    """How the routing spread the load, over the batches' `routing` lists:
    `dropped_pct`, the share of expert choices dropped in the worst layer
    (%); `dropped_mean_pct`, over all layers; `load_max`, the most tokens
    one expert took of one prompt over the mean, S x K / E."""
    e, k = c["num_local_experts"], c["num_experts_per_tok"]
    drops, top = [], 0.0
    for li in range(len(routings[0])):
        topi = torch.cat([r[li]["topi"] for r in routings])      # (N, S, K)
        kept = torch.cat([r[li]["kept"] for r in routings])      # (N, E, S)
        n, s, _ = topi.shape
        counts = torch.zeros(n, e, device=topi.device).scatter_add_(
            1, topi.reshape(n, -1), torch.ones(n, s * k, device=topi.device))
        drops.append(1.0 - kept.sum().item() / (n * s * k))
        top = max(top, counts.max().item() / (s * k / e))
    return {"dropped_pct": 100.0 * max(drops),
            "dropped_mean_pct": 100.0 * sum(drops) / len(drops),
            "load_max": top}

