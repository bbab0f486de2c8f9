"""Kimi K2 Instruct, as published (port only; the reference has no such
arch). [hf:moonshotai/Kimi-K2-Instruct/config.json]
61 layers, d_model 7168, 64 heads of multi-head latent attention
(q_lora 1536, kv_lora 512, qk 128 + 64, v 128; YaRN on the 64 rotary
dims: theta 50,000, factor 32 over 4,096 positions, betas 1, mscales 1),
vocab 163,840, RMSNorm eps 1e-6, untied embeddings. Layer 0 is dense
(d_ff 18,432); layers 1-60 are MoE: 384 routed experts of width 2,048,
top 8 by sigmoid score plus a correction bias, renormalised and scaled
by 2.827, dropless, and one shared expert of width 2,048.

`kimi-k2-instruct` is the whole model (every expert held);
`kimi-k2-instruct-ep32` the 60 MoE layers as one rank of 32-way expert
parallelism holds them: experts 0-11 of 384, the router over all 384,
attention and the shared expert whole (DeepSeek-V3's prefill unit,
arXiv:2412.19437 section 3.4.1)."""
import dataclasses

from repro_torch.models.config import (ModelConfig, RoutedMoEConfig, Segment,
                                       YarnMLAConfig)

MLA = YarnMLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128, rope_factor=32.0,
                    original_max_position=4096, beta_fast=1.0, beta_slow=1.0,
                    mscale=1.0, mscale_all_dim=1.0)
MOE = RoutedMoEConfig(num_experts=384, num_experts_per_tok=8,
                      d_ff_expert=2048, num_shared_experts=1,
                      d_ff_shared=2048, routed_scale=2.827)

CONFIG = ModelConfig(
    name="kimi-k2-instruct", family="moe",
    d_model=7168, num_heads=64, num_kv_heads=64,
    d_ff=18432, vocab_size=163840,
    segments=(Segment(("mla",), 1), Segment(("mla_moe",), 60)),
    mla=MLA, moe=MOE,
    rope_theta=50000.0, rms_eps=1e-6,
    tp_pad_heads=16,
)

SMOKE = ModelConfig(
    name="kimi-k2-instruct-smoke", family="moe",
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512,
    segments=(Segment(("mla",), 1), Segment(("mla_moe",), 2)),
    mla=YarnMLAConfig(q_lora_rank=32, kv_lora_rank=24, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, rope_factor=32.0,
                      original_max_position=16, beta_fast=1.0,
                      beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
    moe=RoutedMoEConfig(num_experts=16, num_experts_per_tok=4,
                        d_ff_expert=32, num_shared_experts=1, d_ff_shared=32,
                        routed_scale=2.827),
    rope_theta=50000.0, rms_eps=1e-6,
)

EP32 = dataclasses.replace(
    CONFIG, name="kimi-k2-instruct-ep32",
    segments=(Segment(("mla_moe",), 60),),
    moe=dataclasses.replace(MOE, held=12, first_held=0))

EP32_SMOKE = dataclasses.replace(
    SMOKE, name="kimi-k2-instruct-ep32-smoke",
    segments=(Segment(("mla_moe",), 2),),
    moe=dataclasses.replace(SMOKE.moe, held=4, first_held=0))
