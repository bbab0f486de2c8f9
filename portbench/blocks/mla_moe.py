"""The `mla_moe` block kind's weights and how they go into the program.

MLA (`blocks/mla.py`'s leaves, names and counts, without its MLP) beside
a MoE FFN routed as DeepSeek-V3 and Kimi K2 route it (`reference/mla_moe.py`):
the fp32 `router` (d, E) over all `router_experts` E, its fp32
`correction_bias` (E,) (the published `e_score_correction_bias`), the
`n_routed_experts` experts held here (`w1` gate, `w3` up, `w2` down, as
`x @ W` matrices), experts `first_held_expert` on, and the shared
expert (`shared_w1`, `shared_w3`, `shared_w2`). `matmul_weights` and
`attention_dims` count the block's work at those widths: a token's
routed work is the held share of its `num_experts_per_tok` experts.
`load` hands the leaves to the port's `Block` (its `mla` and `moe`
modules); `program_cache` is `mla`'s. `TAP` names the port's function
whose calls carry the routing decisions, `routing` reads them for the
reference to follow, and `load_spread` says how they spread the load.
"""
from __future__ import annotations

import torch

from . import mla, padded

BF16, F32 = torch.bfloat16, torch.float32

#: The port's dropless MoE calls `top_k` once a layer: over each token's
#: biased scores, its K experts.
TAP = "repro_torch.models.layers:top_k"

#: The correction bias's std before `draw_scale`: the order of the gaps
#: between a token's biased scores near its 8th choice.
BIAS_STD = 0.005

attention_dims = mla.attention_dims
program_cache = mla.program_cache


def _mla_leaves(c: dict) -> list:
    return [leaf for leaf in mla.leaves(c) if not leaf[0].startswith("mlp_")]


def leaves(c: dict) -> list[tuple[str, tuple, torch.dtype, float | None]]:
    """(name, shape, dtype, std) of one layer's leaves; std None marks a
    norm scale, drawn as 1 + 0.1 N(0, 1). The router and its bias are
    float32, as the port serves them."""
    d, e, held = c["hidden_size"], c["router_experts"], c["n_routed_experts"]
    f = c["moe_intermediate_size"]
    fs = f * c["n_shared_experts"]
    return _mla_leaves(c) + [
        ("router", (d, e), F32, d ** -0.5),
        ("correction_bias", (e,), F32, BIAS_STD),
        ("w1", (held, d, f), BF16, d ** -0.5),
        ("w3", (held, d, f), BF16, d ** -0.5),
        ("w2", (held, f, d), BF16, f ** -0.5),
        ("shared_w1", (d, fs), BF16, d ** -0.5),
        ("shared_w3", (d, fs), BF16, d ** -0.5),
        ("shared_w2", (fs, d), BF16, fs ** -0.5),
    ]


def matmul_weights(c: dict) -> int:
    """Matmul weights one token multiplies through in one block, at the
    published widths: MLA's q_a, q_b, kv_a, kv_b and o, the router, the
    shared expert, and of its `num_experts_per_tok` routed experts the
    share held here (K x held / E, on average over tokens)."""
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    attn = mla.matmul_weights(c) - 3 * d * c["intermediate_size"]
    router = d * c["router_experts"]
    shared = 3 * d * f * c["n_shared_experts"]
    routed = (c["num_experts_per_tok"] * c["n_routed_experts"] * 3 * d * f
              // c["router_experts"])
    return attn + router + shared + routed


def check_port(cfg, c: dict) -> None:
    """The port's configuration has the published widths, the stated
    routing (the port's dropless routing is always sigmoid scores, top K
    of score plus bias as `noaux_tc`, renormalised), the experts held and
    YaRN's parameters."""
    m, a, y = cfg.moe, cfg.mla, c["rope_scaling"]
    got = (cfg.d_model, cfg.num_heads, cfg.vocab_size, a.q_lora_rank,
           a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
           a.v_head_dim, cfg.rms_eps, cfg.rope_theta, cfg.tie_embeddings,
           a.rope_factor, a.original_max_position, a.beta_fast, a.beta_slow,
           a.mscale, a.mscale_all_dim, m.num_experts, m.num_experts_per_tok,
           m.d_ff_expert, m.num_shared_experts, m.d_ff_shared,
           m.held_experts, m.first_held, "sigmoid", "noaux_tc", True,
           m.routed_scale)
    want = (c["hidden_size"], c["num_attention_heads"], c["vocab_size"],
            c["q_lora_rank"], c["kv_lora_rank"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"], c["rms_norm_eps"],
            c["rope_theta"], c["tie_word_embeddings"], y["factor"],
            y["original_max_position_embeddings"], y["beta_fast"],
            y["beta_slow"], y["mscale"], y["mscale_all_dim"],
            c["router_experts"], c["num_experts_per_tok"],
            c["moe_intermediate_size"], c["n_shared_experts"],
            c["moe_intermediate_size"], c["n_routed_experts"],
            c["first_held_expert"], c["scoring_func"], c["topk_method"],
            c["norm_topk_prob"],
            c["routed_scaling_factor"])
    if got != want:
        raise SystemExit(f"the port's {cfg.name} has {got}, the benchmark's "
                         f"configuration {want}")


def load(block, w: dict, cfg, c: dict) -> None:
    """Set the parameters of the port's `mla_moe` block from the
    published leaves `w` (shared where the layouts agree, derived where
    not: MLA's ghost heads and per-head absorptions, as `blocks/mla.py`
    derives them)."""
    par = torch.nn.Parameter
    m, h, hp = block.mla, c["num_attention_heads"], cfg.num_heads_padded
    nope, rot, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    kl, d = c["kv_lora_rank"], c["hidden_size"]
    kvb = w["kv_b"].view(kl, h, nope + dv)
    m.w_dq = par(w["q_a"], requires_grad=False)
    m.q_norm = par(w["q_a_norm"], requires_grad=False)
    m.w_uq = par(padded(w["q_b"], (c["q_lora_rank"], hp * (nope + rot))),
                 requires_grad=False)
    m.w_dkv = par(w["kv_a"], requires_grad=False)
    m.kv_norm = par(w["kv_a_norm"], requires_grad=False)
    m.w_uk = par(padded(kvb[..., :nope].permute(1, 2, 0).contiguous(),
                            (hp, nope, kl)), requires_grad=False)
    m.w_uv = par(padded(kvb[..., nope:].permute(1, 0, 2).contiguous(),
                            (hp, kl, dv)), requires_grad=False)
    m.wo = par(padded(w["o"], (hp * dv, d)), requires_grad=False)
    moe = block.moe
    moe.router = par(w["router"], requires_grad=False)
    moe.correction_bias = par(w["correction_bias"], requires_grad=False)
    moe.w_gate = par(w["w1"], requires_grad=False)
    moe.w_up = par(w["w3"], requires_grad=False)
    moe.w_down = par(w["w2"], requires_grad=False)
    moe.shared.w_gate = par(w["shared_w1"], requires_grad=False)
    moe.shared.w_up = par(w["shared_w3"], requires_grad=False)
    moe.shared.w_down = par(w["shared_w2"], requires_grad=False)
    block.norm1 = par(w["norm1"], requires_grad=False)
    block.norm2 = par(w["norm2"], requires_grad=False)


def routing(calls: list, c: dict, layers: int) -> list[dict] | None:
    """The port's routing decisions from the `TAP` calls of one prefill
    ((arguments, result) each, in order): per layer {"topi": (B, S, K)},
    each token's experts over all E; None if the calls are not one a
    layer of those shapes."""
    e, k = c["router_experts"], c["num_experts_per_tok"]
    if len(calls) != layers:
        return None
    out = []
    for args, (_, topi) in calls:
        if args[0].shape[-1] != e or topi.shape[-1] != k or topi.dim() != 3:
            return None
        out.append({"topi": topi})
    return out


def load_spread(routings: list[list[dict]], c: dict) -> dict:
    """How the routing spread the load, over the batches' `routing` lists:
    `held_pct`, the share of all choices that took a held expert (12 /
    384 = 3.125% if even); `rows_max`, the rows of the most loaded held
    expert in any layer over the mean, tokens x K / E; `rows_min`, of
    the least loaded; `load_max`, of the most loaded of all E experts."""
    e, k = c["router_experts"], c["num_experts_per_tok"]
    e0, held = c["first_held_expert"], c["n_routed_experts"]
    shares, top, low, top_all = [], 0.0, float("inf"), 0.0
    for li in range(len(routings[0])):
        topi = torch.cat([r[li]["topi"] for r in routings]).reshape(-1)
        counts = torch.bincount(topi, minlength=e).float()
        mean = topi.numel() / e
        mine = counts[e0:e0 + held]
        shares.append(mine.sum().item() / topi.numel())
        top = max(top, mine.max().item() / mean)
        low = min(low, mine.min().item() / mean)
        top_all = max(top_all, counts.max().item() / mean)
    return {"held_pct": 100.0 * sum(shares) / len(shares), "rows_max": top,
            "rows_min": low, "load_max": top_all}
