"""Kimi K2 — trillion-parameter MoE (61L, 384 experts, top-8).
[arXiv:2501.kimi2; unverified] Assigned spec: d_model=7168, 64H (GQA kv=8),
expert d_ff=2048, vocab=163840."""
from repro_torch.models.config import ModelConfig, MoEConfig, Segment

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    d_model=7168, num_heads=64, num_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    segments=(Segment(("attn_moe",), 61),),
    moe=MoEConfig(num_experts=384, num_experts_per_tok=8, d_ff_expert=2048,
                  capacity_factor=1.25),
    rope_theta=500000.0,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512,
    segments=(Segment(("attn_moe",), 2),),
    # capacity_factor sized so the smoke shapes are dropless (C == S):
    # capacity-dropping is a train-time approximation; the decode-vs-train
    # consistency smoke test must not be confounded by it.
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2, d_ff_expert=64,
                  capacity_factor=8.0),
    rope_theta=10000.0,
)
