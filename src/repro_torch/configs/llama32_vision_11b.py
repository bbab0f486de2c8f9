"""Llama 3.2 Vision 11B — cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified] Assigned spec: 40L,
d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=128256. The vision frontend
is a STUB: input_specs() provides precomputed patch embeddings
(4 tiles x 1601 patches = 6404 tokens)."""
from repro_torch.models.config import ModelConfig, Segment

VISION_SEQ = 6404

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    segments=(Segment(("attn", "attn", "attn", "attn", "cross_attn"), 8),),
    rope_theta=500000.0, vision_seq=VISION_SEQ,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    segments=(Segment(("attn", "attn", "attn", "attn", "cross_attn"), 1),),
    rope_theta=10000.0, vision_seq=12,
)
