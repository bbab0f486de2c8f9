"""Phi-3.5-MoE — 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
Assigned spec: 32L, d_model=4096, 32H (GQA kv=8), expert d_ff=6400,
vocab=32064."""
from repro_torch.models.config import ModelConfig, MoEConfig, Segment

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    segments=(Segment(("attn_moe",), 32),),
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, d_ff_expert=6400,
                  capacity_factor=1.25),
    rope_theta=10000.0,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=96, vocab_size=512,
    segments=(Segment(("attn_moe",), 2),),
    moe=MoEConfig(num_experts=4, num_experts_per_tok=2, d_ff_expert=96),
    rope_theta=10000.0,
)
