"""HuBERT X-Large — encoder-only audio backbone (same arch as wav2vec2).
[arXiv:2106.07447; unverified] Assigned spec: 48L, d_model=1280, 16H
(kv=16), d_ff=5120, vocab=504 (cluster targets). The modality frontend
(conv feature extractor) is a STUB: input_specs() provides precomputed
frame embeddings. No autoregressive decode (decode/long shapes skipped)."""
from repro_torch.models.config import ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    segments=uniform_segments("attn", 48),
    causal=False, embed_inputs=False, rope_theta=10000.0,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio",
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=32,
    segments=uniform_segments("attn", 2),
    causal=False, embed_inputs=False, rope_theta=10000.0,
)
