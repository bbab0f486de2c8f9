"""RWKV6 7B (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; hf] Assigned spec: 32L, d_model=4096, d_ff=14336,
vocab=65536. O(1) decode state: runs long_500k natively."""
from repro_torch.models.config import ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    d_model=4096, num_heads=64, num_kv_heads=64,   # wkv heads (d/64)
    d_ff=14336, vocab_size=65536,
    segments=uniform_segments("rwkv", 32),
    rwkv_head_dim=64,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    segments=uniform_segments("rwkv", 2),
    rwkv_head_dim=16,
)
