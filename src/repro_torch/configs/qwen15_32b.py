"""Qwen1.5 32B — QKV bias, MHA-like GQA (kv=40). [hf:Qwen/Qwen1.5-0.5B; hf]
Assigned spec: 64L, d_model=5120, 40H (kv=40), d_ff=27392, vocab=152064."""
from repro_torch.models.config import ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    segments=uniform_segments("attn", 64),
    qkv_bias=True, rope_theta=1000000.0,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=512,
    segments=uniform_segments("attn", 2),
    qkv_bias=True, rope_theta=10000.0,
)
