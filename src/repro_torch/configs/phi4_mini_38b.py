"""Phi-4-mini 3.8B — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]
Assigned spec: 32L, d_model=3072, 24H (GQA kv=8), d_ff=8192, vocab=200064."""
from repro_torch.models.config import ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    segments=uniform_segments("attn", 32),
    rope_theta=10000.0, tie_embeddings=True,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke", family="dense",
    d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    segments=uniform_segments("attn", 2),
    rope_theta=10000.0, tie_embeddings=True,
)
