"""Reference `mla_moe` block (Kimi K2, DeepSeek-V3): multi-head latent
attention with YaRN on its rotary dims, and a MoE FFN with sigmoid
routing, a correction bias and a shared expert, pre-norm with
residuals, in float32.

Attention is `mla.py`'s published, non-absorbed form at head dims
qk_nope + qk_rope and v, the rotary dims rotated at YaRN's frequencies
(`yarn`) and the softmax scaled by (qk_nope + qk_rope)^-1/2 g(s,
mscale_all_dim)^2 (`softmax_scale`). The rotary key is shared by every
head; the cache is the normed latent `ckv` and the rotated key `kr`.

Routing (`route`): each token's scores s = sigmoid(h W_r) over all
`router_experts` experts, its `num_experts_per_tok` experts the top of
s + b (b the correction bias, which only chooses), their weights s_e /
sum of the chosen s x `routed_scaling_factor`. No capacity: every
choice is computed. This chip holds experts `first_held_expert` ..
`first_held_expert + n_routed_experts - 1` of them: the layer adds
those experts' weighted outputs for the tokens routed to them, and the
shared expert for every token; what the other experts would add lies on
other chips and is left out here as in the program. Routing is
discontinuous, so the layer can follow another side's choices and
report how far they stand from its own (`route`).

Departures from the published model, each also in the configuration's
`departures`:
- the rotation is half-split, as the port's: the checkpoint rotates
  interleaved pairs, which is a fixed permutation of the rotary columns
  of q_b and kv_a;
- the stage cut: 30 of the 60 MoE layers, and not layer 0 (dense);
- bf16 weights (drawn from the seed), computed here in float32.

Weights are `x @ W` matrices named as in `portbench/blocks/mla_moe.py`.
"""
from __future__ import annotations

import math

import torch

from .model import causal_attention, mm, rms_norm, swiglu
from .precision import Precision


def _mscale(s: float, m: float) -> float:
    return 0.1 * m * math.log(s) + 1.0 if s > 1 else 1.0


def yarn(c: dict, device) -> tuple[torch.Tensor, float]:
    """YaRN's inverse frequencies over the r = qk_rope_head_dim rotary dims
    (float64) and the cos / sin factor, from `rope_scaling` (s = factor,
    L0 = original_max_position_embeddings):

    - f_i = theta^(-2i / r), i = 0 .. r / 2 - 1;
    - c(beta) = r ln(L0 / (2 pi beta)) / (2 ln theta); low =
      floor(c(beta_fast)), high = ceil(c(beta_slow)), clamped to
      [0, r - 1]; high + 0.001 where they are equal;
    - ramp_i = clamp((i - low) / (high - low), 0, 1);
    - inv_freq_i = f_i / s ramp_i + f_i (1 - ramp_i);
    - the factor g(s, mscale) / g(s, mscale_all_dim), g(s, m) =
      0.1 m ln s + 1.

    Kimi K2: low 19, high 20; pairs 0-19 keep f_i, 20-31 take f_i / 32;
    the factor is 1."""
    r, theta, y = c["qk_rope_head_dim"], float(c["rope_theta"]), c["rope_scaling"]
    s, l0 = float(y["factor"]), y["original_max_position_embeddings"]

    def corr(beta: float) -> float:
        return r * math.log(l0 / (2 * math.pi * beta)) / (2 * math.log(theta))
    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), r - 1)
    if low == high:
        high += 0.001
    i = torch.arange(r // 2, dtype=torch.float64, device=device)
    f = theta ** (-2.0 * i / r)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return (f / s * ramp + f * (1.0 - ramp),
            _mscale(s, y["mscale"]) / _mscale(s, y["mscale_all_dim"]))


def softmax_scale(c: dict) -> float:
    y = c["rope_scaling"]
    return ((c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
            * _mscale(float(y["factor"]), y["mscale_all_dim"]) ** 2)


def rope(x: torch.Tensor, inv: torch.Tensor, factor: float) -> torch.Tensor:
    """Half-split rotation of the last dim at inverse frequencies `inv`,
    cos and sin times `factor`, positions 0 .. S - 1 along dim -2."""
    s, r = x.shape[-2], x.shape[-1]
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = (ang.cos() * factor).float(), (ang.sin() * factor).float()
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def route(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          c: dict, prec: Precision, follow: dict | None = None
          ) -> tuple[torch.Tensor, torch.Tensor, dict, float]:
    """h (N, S, d) -> (topi (N, S, K) each token's experts, their weights
    (N, S, K), the decisions {"topi"}, the gap).

    With `follow` (another side's decisions) the experts are those and
    the weights this side's; the gap is how far a followed expert's
    biased score lies below this side's K-th best, at worst."""
    k = c["num_experts_per_tok"]
    s = torch.sigmoid(mm(h, router, prec))
    biased = s + bias.float()
    best = torch.sort(biased, dim=-1, descending=True, stable=True)
    topi = best.indices[..., :k] if follow is None else follow["topi"]
    gap = 0.0
    if follow is not None:
        gap = (best.values[..., k - 1]
               - biased.gather(-1, topi).min(-1).values).max().item()
    w = s.gather(-1, topi)
    w = w / w.sum(-1, keepdim=True) * c["routed_scaling_factor"]
    return topi, w, {"topi": topi}, max(gap, 0.0)


def layer(x: torch.Tensor, w: dict, c: dict, prec: Precision,
          follow: dict | None = None
          ) -> tuple[torch.Tensor, dict, dict, float]:
    """x (N, S, d) float32 -> (x, {"ckv": (N, S, kv_lora), "kr": (N, S,
    rope)}, the routing decisions, their gap): see `route`."""
    n, s, d = x.shape
    eps = c["rms_norm_eps"]
    heads, nope = c["num_attention_heads"], c["qk_nope_head_dim"]
    rot, dv, lora = c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    inv, factor = yarn(c, x.device)

    h = rms_norm(x, w["norm1"], eps)
    cq = rms_norm(mm(h, w["q_a"], prec), w["q_a_norm"], eps)
    q = mm(cq, w["q_b"], prec).view(n, s, heads, nope + rot).transpose(1, 2)
    kv = mm(h, w["kv_a"], prec)
    ckv = rms_norm(kv[..., :lora], w["kv_a_norm"], eps)
    kr = rope(kv[..., lora:], inv, factor)                    # (N, S, rot)
    kvb = mm(ckv, w["kv_b"], prec).view(n, s, heads, nope + dv)
    kvb = kvb.transpose(1, 2)                                 # (N, H, S, .)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], inv, factor)], dim=-1)
    k = torch.cat([kvb[..., :nope],
                   kr[:, None].expand(n, heads, s, rot)], dim=-1)
    v = kvb[..., nope:]
    out = torch.stack([causal_attention(q[i], k[i], v[i], softmax_scale(c),
                                        prec) for i in range(n)])
    del q, k, v, kvb
    out = out.transpose(1, 2).reshape(n, s, heads * dv)
    x = x + mm(out, w["o"], prec)
    del out

    h = rms_norm(x, w["norm2"], eps)
    out, decided, gap = moe(h, w, c, prec, follow)
    return x + out, {"ckv": ckv, "kr": kr}, decided, gap


def moe(h: torch.Tensor, w: dict, c: dict, prec: Precision,
        follow: dict | None = None) -> tuple[torch.Tensor, dict, float]:
    """h (N, S, d), the normed residual -> (the held experts' weighted
    outputs for the tokens routed to them plus the shared expert's, the
    routing decisions, their gap): see `route`."""
    n, s, d = h.shape
    topi, weight, decided, gap = route(h, w["router"], w["correction_bias"],
                                       c, prec, follow)
    e0 = c["first_held_expert"]
    out = torch.zeros_like(h)
    hf, tf, wf = h.reshape(n * s, d), topi.reshape(n * s, -1), \
        weight.reshape(n * s, -1)
    for j in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero(tf == e0 + j, as_tuple=True)
        if tok.numel():
            y = swiglu(hf[tok], w["w1"][j], w["w3"][j], w["w2"][j], prec)
            out.view(n * s, d).index_add_(0, tok, wf[tok, slot, None] * y)
    out = out + swiglu(h, w["shared_w1"], w["shared_w3"], w["shared_w2"],
                       prec)
    return out, decided, gap
