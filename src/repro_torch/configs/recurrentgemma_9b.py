"""RecurrentGemma 9B — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; unverified] Assigned spec: 38L, d_model=4096, 16H
(GQA kv=1 = MQA), d_ff=12288, vocab=256000, window=2048.
38 = 12 x (rg, rg, local_attn) + (rg, rg). Sub-quadratic: runs long_500k."""
from repro_torch.models.config import ModelConfig, Segment

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    segments=(Segment(("rg", "rg", "local_attn"), 12),
              Segment(("rg", "rg"), 1)),
    window=2048, rope_theta=10000.0, tie_embeddings=True,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
    segments=(Segment(("rg", "rg", "local_attn"), 1),
              Segment(("rg", "rg"), 1)),
    window=8, rope_theta=10000.0, tie_embeddings=True,
)
