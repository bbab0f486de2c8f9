"""Llama 3.2 3B — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]
Assigned spec: 28L, d_model=3072, 24H (GQA kv=8), d_ff=8192, vocab=128256."""
from repro_torch.models.config import ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    segments=uniform_segments("attn", 28),
    rope_theta=500000.0, tie_embeddings=True,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", family="dense",
    d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    segments=uniform_segments("attn", 2),
    rope_theta=10000.0, tie_embeddings=True,
)
