"""MiniCPM3 4B — Multi-head Latent Attention. [hf:openbmb/MiniCPM3-4B; hf]
Assigned spec: 62L, d_model=2560, 40H, d_ff=6400, vocab=73448. MLA dims from
the HF config: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v=64."""
from repro_torch.models.config import MLAConfig, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    segments=uniform_segments("mla", 62),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="minicpm3-smoke", family="dense",
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    segments=uniform_segments("mla", 2),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=24, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    rope_theta=10000.0,
)
