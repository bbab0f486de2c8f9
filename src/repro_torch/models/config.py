"""Model configuration schema (port of `repro.models.config`).

Plain data, carried over unchanged so that a configuration means the same
model in both packages. A model is a sequence of *segments*; each segment
is `count` copies of one superblock of block kinds. The port runs every
kind listed in `BLOCK_KINDS`; `mla_moe` (MLA beside a MoE FFN, as in
DeepSeek-V3 and Kimi K2) is the port's own and has no reference kind.
Its configurations use two subclasses that only the port has,
`RoutedMoEConfig` (sigmoid scores, a correction bias, dropless routing
over a held share of the experts) and `YarnMLAConfig` (YaRN on MLA's
rotary dims); `MoEConfig`, `MLAConfig` and `ModelConfig` keep the
reference's fields.
"""
from __future__ import annotations

import dataclasses

BLOCK_KINDS = (
    "attn",        # self-attention + MLP (dense transformer layer)
    "attn_moe",    # self-attention + MoE FFN
    "mla",         # multi-head latent attention + MLP
    "rg",          # RG-LRU recurrent block (Griffin) + MLP
    "local_attn",  # windowed self-attention + MLP
    "rwkv",        # RWKV6 time-mix + channel-mix
    "cross_attn",  # cross-attention (vision) + MLP
    "mla_moe",     # multi-head latent attention + MoE FFN (port only)
)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class YarnMLAConfig(MLAConfig):
    """MLA with YaRN scaling of its rotary dims (DeepSeek-V3, Kimi K2;
    port only): `layers.yarn_freqs` gives the rotary table and its cos /
    sin factor, `layers.mla_softmax_scale` the attention's scale."""
    rope_factor: float = 1.0                # s
    original_max_position: int = 4096       # L0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    num_experts_per_tok: int = 2
    d_ff_expert: int = 6400
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class RoutedMoEConfig(MoEConfig):
    """A dropless MoE routed as DeepSeek-V3 and Kimi K2 route (port only):
    each token's fp32 sigmoid scores over all `num_experts`, its top
    `num_experts_per_tok` chosen on the scores plus a per-expert fp32
    correction bias (which never enters a weight), the chosen scores
    renormalised and times `routed_scale`. No capacity: every (token,
    expert) choice is computed (`capacity_factor` unused). The layer
    holds experts `first_held` .. `first_held + held - 1` (all of them
    when `held` is 0) and computes only their part of the output, as one
    rank of expert parallelism does without the exchange."""
    routed_scale: float = 1.0
    held: int = 0
    first_held: int = 0

    def __post_init__(self):
        assert 0 <= self.first_held and \
            self.first_held + self.held_experts <= self.num_experts

    @property
    def held_experts(self) -> int:
        return self.held or self.num_experts


@dataclasses.dataclass(frozen=True)
class Segment:
    """`count` scanned copies of a superblock; the superblock is a tuple of
    block kinds executed in order (usually length 1)."""
    blocks: tuple[str, ...]
    count: int

    def __post_init__(self):
        for b in self.blocks:
            assert b in BLOCK_KINDS, b

    @property
    def layers(self) -> int:
        return len(self.blocks) * self.count


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: tuple[Segment, ...]
    head_dim: int = 0               # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True             # False => encoder-only (audio)
    window: int = 0                 # local attention window (hybrid)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # vlm: length of the precomputed vision-embedding sequence (frontend STUB)
    vision_seq: int = 0
    # audio: frontend STUB provides frame embeddings directly
    embed_inputs: bool = True       # False => inputs are already embeddings
    # rwkv
    rwkv_head_dim: int = 64
    # Ghost-head padding: pad attention head counts to a multiple of this
    # (the model-axis size of the reference's tensor-parallel mesh). Ghost
    # q heads have zero wq columns and zero wo rows, ghost kv heads only
    # pair with ghost q heads, so outputs equal the unpadded model's.
    tp_pad_heads: int = 0

    def __post_init__(self):
        assert self.family in ("dense", "moe", "hybrid", "ssm", "vlm", "audio")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_heads_padded(self) -> int:
        p = self.tp_pad_heads
        if not p:
            return self.num_heads
        return (self.num_heads + p - 1) // p * p

    @property
    def num_kv_heads_padded(self) -> int:
        hq = self.num_heads_padded
        hkv = self.num_kv_heads
        if hq % hkv == 0:
            return hkv
        # smallest kv count >= hkv that divides the padded q count
        for cand in range(hkv, hq + 1):
            if hq % cand == 0:
                return cand
        return hq

    @property
    def num_layers(self) -> int:
        return sum(s.layers for s in self.segments)

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no autoregressive decode step."""
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """True if no full-attention block (long_500k runnable)."""
        kinds = {b for s in self.segments for b in s.blocks}
        return not (kinds & {"attn", "attn_moe", "mla", "mla_moe",
                             "cross_attn"})

    def param_count(self) -> int:
        """Analytic parameter count (used in roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d                                       # embed
        if not self.tie_embeddings:
            total += v * d                                  # unembed
        for seg in self.segments:
            per_block = 0
            for b in seg.blocks:
                if b in ("attn", "attn_moe", "local_attn", "cross_attn"):
                    qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                    o = self.num_heads * hd * d
                    per_block += qkv + o
                    if b == "attn_moe":
                        m = self.moe
                        per_block += d * m.num_experts                    # router
                        per_block += m.num_experts * 3 * d * m.d_ff_expert
                        per_block += m.num_shared_experts * 3 * d * m.d_ff_shared
                    else:
                        per_block += 3 * d * self.d_ff                    # swiglu
                elif b in ("mla", "mla_moe"):
                    c = self.mla
                    qk_head = c.qk_nope_head_dim + c.qk_rope_head_dim
                    per_block += d * c.q_lora_rank + c.q_lora_rank * self.num_heads * qk_head
                    per_block += d * (c.kv_lora_rank + c.qk_rope_head_dim)
                    per_block += c.kv_lora_rank * self.num_heads * (c.qk_nope_head_dim + c.v_head_dim)
                    per_block += self.num_heads * c.v_head_dim * d
                    if b == "mla":
                        per_block += 3 * d * self.d_ff
                    else:       # the router, its bias, the held experts
                        m = self.moe
                        per_block += d * m.num_experts + m.num_experts
                        per_block += m.held_experts * 3 * d * m.d_ff_expert
                        per_block += m.num_shared_experts * 3 * d * m.d_ff_shared
                elif b == "rg":
                    dr = _rg_width(d)
                    per_block += 2 * d * dr + dr * d        # in/out proj
                    per_block += 4 * dr + 2 * dr            # conv4 + gates(diag-ish)
                    per_block += 2 * dr * dr                # input/recurrence gates
                    per_block += 3 * d * self.d_ff
                elif b == "rwkv":
                    per_block += 4 * d * d + d * d          # r,k,v,o + w-proj
                    per_block += 2 * d                      # decay/bonus per channel
                    per_block += 2 * d * self.d_ff          # channel-mix (relu^2)
                per_block += 2 * d                          # 2 RMSNorm scales
            total += per_block * seg.count
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts) — the N in
        MODEL_FLOPS = 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_like = self.param_count()
        per_expert = 3 * self.d_model * m.d_ff_expert
        moe_layers = sum(s.count * sum(1 for b in s.blocks
                                       if b in ("attn_moe", "mla_moe"))
                         for s in self.segments)
        held = getattr(m, "held_experts", m.num_experts)
        inactive = max(held - m.num_experts_per_tok, 0) * per_expert * moe_layers
        return dense_like - inactive


def _rg_width(d_model: int) -> int:
    """Griffin uses an expanded recurrence width (~4/3 d)."""
    return (d_model * 4 // 3 + 127) // 128 * 128


def uniform_segments(kind: str, n_layers: int) -> tuple[Segment, ...]:
    return (Segment((kind,), n_layers),)
