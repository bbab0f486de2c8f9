"""The `mla` block kind's weights and how they go into the program.

`leaves` is the published layout (MiniCPM3's names, as `x @ W` matrices)
and how each leaf is drawn: the benchmark makes these. `matmul_weights`
and `attention_dims` count the block's work at those widths
(`portbench/workcount.py`). `load` hands them
to the port's `Block` (`repro_torch.models.model.Block`, its `mla` and
`mlp` modules); what the port derives from them (the ghost heads of
`tp_pad_heads`, the per-head absorptions `w_uk`, `w_uv` split out of
`kv_b`) is derived here and nowhere else. `program_cache` reads one
prompt's cache of one layer out of the port's prefill cache, in the
reference's layout.
"""
from __future__ import annotations

import torch

from . import padded

BF16 = torch.bfloat16


def leaves(c: dict) -> list[tuple[str, tuple, torch.dtype, float | None]]:
    """(name, shape, dtype, std) of one layer's leaves; std None marks a
    norm scale, drawn as 1 + 0.1 N(0, 1)."""
    d, h, f = c["hidden_size"], c["num_attention_heads"], c["intermediate_size"]
    ql, kl = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rot, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return [
        ("norm1", (d,), BF16, None),
        ("q_a", (d, ql), BF16, d ** -0.5),
        ("q_a_norm", (ql,), BF16, None),
        ("q_b", (ql, h * (nope + rot)), BF16, ql ** -0.5),
        ("kv_a", (d, kl + rot), BF16, d ** -0.5),
        ("kv_a_norm", (kl,), BF16, None),
        ("kv_b", (kl, h * (nope + dv)), BF16, kl ** -0.5),
        ("o", (h * dv, d), BF16, (h * dv) ** -0.5),
        ("norm2", (d,), BF16, None),
        ("mlp_gate", (d, f), BF16, d ** -0.5),
        ("mlp_up", (d, f), BF16, d ** -0.5),
        ("mlp_down", (f, d), BF16, f ** -0.5),
    ]


def matmul_weights(c: dict) -> int:
    """Matmul weights one token multiplies through in one block, at the
    published widths: q_a, q_b, kv_a, kv_b, o and the MLP's three."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = (d * c["q_lora_rank"] + c["q_lora_rank"] * h * qk
            + d * (c["kv_lora_rank"] + c["qk_rope_head_dim"])
            + c["kv_lora_rank"] * h * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + h * c["v_head_dim"] * d)
    return attn + 3 * d * c["intermediate_size"]


def attention_dims(c: dict) -> tuple[int, int, int, int]:
    """(query heads, key / value heads, dk, dv) of the published,
    non-absorbed form: each head has its own key (nope + rope) and value."""
    h = c["num_attention_heads"]
    return (h, h, c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
            c["v_head_dim"])


def check_port(cfg, c: dict) -> None:
    """The port's configuration has the published widths."""
    m = cfg.mla
    got = (cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.vocab_size, m.q_lora_rank,
           m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
           m.v_head_dim, cfg.rms_eps, cfg.rope_theta, cfg.tie_embeddings)
    want = (c["hidden_size"], c["num_attention_heads"], c["intermediate_size"],
            c["vocab_size"], c["q_lora_rank"], c["kv_lora_rank"],
            c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
            c["rms_norm_eps"], c["rope_theta"], c["tie_word_embeddings"])
    if got != want:
        raise SystemExit(f"the port's {cfg.name} has {got}, the benchmark's "
                         f"configuration {want}")


def load(block, w: dict, cfg, c: dict) -> None:
    """Set the parameters of the port's `mla` block from the published
    leaves `w` (shared where the layouts agree, derived where not)."""
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
    block.mlp.w_gate = par(w["mlp_gate"], requires_grad=False)
    block.mlp.w_up = par(w["mlp_up"], requires_grad=False)
    block.mlp.w_down = par(w["mlp_down"], requires_grad=False)
    block.norm1 = par(w["norm1"], requires_grad=False)
    block.norm2 = par(w["norm2"], requires_grad=False)


def program_cache(leaf: dict, layer: int, row: int, c: dict) -> dict:
    """The port's `mla` cache {"ckv": (L, B, S, kv_lora), "kr": (L, B, S,
    rope)} at one layer and batch row -> {"ckv": (S, kv_lora), "kr": (S,
    rope)}."""
    return {"ckv": leaf["ckv"][layer, row], "kr": leaf["kr"][layer, row]}
