"""MLA's prefill in the absorbed form, the reference's, for tests that hold
`repro_torch.models.layers.mla_block`'s per-head form against it. Imports
nothing of the reference package, so the card tests can use it too."""
import torch

from repro_torch.models import layers


def absorbed_prefill(m, x, cfg):
    """`mla_block`'s prefill on the absorbed latent: q (B, H, S,
    kv_lora + rope) against one key head concat(ckv, kr) and one value head
    ckv, through `layers.flash_attention` (blockwise at these head dims),
    then W_uv and wo. Returns the attention's output per head after W_uv
    (B, S, H, v) and the block's output (B, S, d)."""
    c = cfg.mla
    B, S, _ = x.shape
    H, qk = cfg.num_heads_padded, c.qk_nope_head_dim + c.qk_rope_head_dim
    ql = layers.rms_norm(x @ m.w_dq, m.q_norm, cfg.rms_eps)
    q = (ql @ m.w_uq).reshape(B, S, H, qk)
    dkv = x @ m.w_dkv
    ckv = layers.rms_norm(dkv[..., :c.kv_lora_rank], m.kv_norm, cfg.rms_eps)
    pos = torch.arange(S, device=x.device)
    q_rope = layers.apply_rope(q[..., c.qk_nope_head_dim:].transpose(1, 2),
                               pos, cfg.rope_theta)
    k_rope = layers.apply_rope(dkv[..., c.kv_lora_rank:][:, None], pos,
                               cfg.rope_theta)
    q_lat = torch.einsum("bshn,hnr->bhsr", q[..., :c.qk_nope_head_dim],
                         m.w_uk)
    qf = torch.cat([q_lat, q_rope], dim=-1)
    kf = torch.cat([ckv[:, None], k_rope], dim=-1)
    out = layers.flash_attention(qf * qk ** -0.5 * qf.shape[-1] ** 0.5, kf,
                                 ckv[:, None], causal=cfg.causal)
    o = torch.einsum("bhsr,hrv->bshv", out, m.w_uv)
    return o, o.reshape(B, S, H * c.v_head_dim) @ m.wo
