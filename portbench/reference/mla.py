"""Reference `mla` block: multi-head latent attention (MiniCPM3,
DeepSeek-V2) and a SwiGLU MLP, pre-norm with residuals, in float32.

Written in the published, non-absorbed form: each head's key is its slice
of the latent's up-projection `kv_b` beside the one shared rotary key, its
value the other slice, and attention runs per head at head dims
qk_nope + qk_rope and v. Weights are `x @ W` matrices named as in
`portbench/blocks/mla.py`. The cache is what a decode step reads: the
normed latent `ckv` and the rotated shared key `kr`.
"""
from __future__ import annotations

import torch

from .model import causal_attention, mm, rms_norm, rope, swiglu
from .precision import Precision


def layer(x: torch.Tensor, w: dict, c: dict, prec: Precision,
          follow: None = None) -> tuple[torch.Tensor, dict, None, float]:
    """x (N, S, d) float32 -> (x, {"ckv": (N, S, kv_lora), "kr": (N, S,
    rope)}, no routing, gap 0)."""
    n, s, _ = x.shape
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    heads, nope = c["num_attention_heads"], c["qk_nope_head_dim"]
    rot, dv, lora = c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]

    h = rms_norm(x, w["norm1"], eps)
    cq = rms_norm(mm(h, w["q_a"], prec), w["q_a_norm"], eps)
    q = mm(cq, w["q_b"], prec).view(n, s, heads, nope + rot).transpose(1, 2)
    kv = mm(h, w["kv_a"], prec)
    ckv = rms_norm(kv[..., :lora], w["kv_a_norm"], eps)
    kr = rope(kv[..., lora:], theta)                          # (N, S, rot)
    kvb = mm(ckv, w["kv_b"], prec).view(n, s, heads, nope + dv)
    kvb = kvb.transpose(1, 2)                                 # (N, H, S, .)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k = torch.cat([kvb[..., :nope],
                   kr[:, None].expand(n, heads, s, rot)], dim=-1)
    v = kvb[..., nope:]
    scale = (nope + rot) ** -0.5
    out = torch.stack([causal_attention(q[i], k[i], v[i], scale, prec)
                       for i in range(n)])                    # (N, H, S, v)
    out = out.transpose(1, 2).reshape(n, s, heads * dv)
    x = x + mm(out, w["o"], prec)
    h = rms_norm(x, w["norm2"], eps)
    x = x + swiglu(h, w["mlp_gate"], w["mlp_up"], w["mlp_down"], prec)
    return x, {"ckv": ckv, "kr": kr}, None, 0.0
