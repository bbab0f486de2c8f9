"""Neural blocks of the port, dense subset (port of `repro.models.layers`).

The `attn` block kind: RMSNorm, rotary embeddings, GQA self-attention with
ghost-head padding, SwiGLU. Activations are bf16, statistics (norms,
softmax) accumulate in fp32, as in the reference. Weights keep the
reference's layout (`x @ W`, W of shape (in, out)) so that a parameter
tree means the same bytes in both packages.

Attention in train and prefill mode routes by shape, as the reference's
`_flash_fn` does: head dims the flash kernel is built for
(`kernels.flash_attention.HEAD_DIMS`) and those that are multiples of 128
go through its wrapper (the hand-written CUDA kernel on the card, its
plain version on the CPU); every other head dim takes the kernel's plain
blockwise forward, the counterpart of the reference's jnp
`_flash_fwd_impl`, on either device. Decode
attends one token against the cache with plain tensor ops, as the
reference does with einsums.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import flash_attention as fa

from .config import ModelConfig


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics, cast back to x's dtype, then the (bf16) scale."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * scale


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """The reference's numpy table (fp64, then fp32), copied to `device`
    once: a copy from pageable host memory waits for the stream, and
    decode would pay it in every layer. Callers must not modify it."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, hd); positions: (S,). Half-split rotation in fp32."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    angles = positions.float()[..., None] * freqs            # (S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """bf16 weights drawn as fp32 normals times `scale`."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(torch.bfloat16)


class SwiGLU(nn.Module):
    """The reference's `swiglu` (forward) with its weights; built with a
    generator it is the reference's `init_swiglu`."""

    def __init__(self, d: int, f: int, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        dev = gen.device if gen is not None else torch.device(device)

        def weight(*shape, scale):
            w = (_normal(gen, shape, scale) if gen is not None else
                 torch.empty(shape, dtype=torch.bfloat16, device=dev))
            return nn.Parameter(w, requires_grad=False)
        self.w_gate = weight(d, f, scale=d ** -0.5)
        self.w_up = weight(d, f, scale=d ** -0.5)
        self.w_down = weight(f, d, scale=f ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = x @ self.w_gate
        up = x @ self.w_up
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        return act @ self.w_down


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

blockwise_calls = 0      # flash_attention calls routed off the kernel
_BLOCKWISE_LOCK = threading.Lock()


def reset_blockwise_calls() -> None:
    global blockwise_calls
    with _BLOCKWISE_LOCK:
        blockwise_calls = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, dk), k: (B, Hkv, Skv, dk), v: (B, Hkv, Skv, dv) ->
    (B, Hq, Sq, dv). Forward only: the training slice brings the
    backward. Routed as the reference's `_flash_fn` routes: (dk, dv) in
    `fa.HEAD_DIMS`, and every dk that is a multiple of 128, go to the flash
    kernel's wrapper, which raises on the card for a pair it lacks
    (dk = dv = 256, ROADMAP B5); every other head dim takes the blockwise
    forward `fa.flash_attention_fwd_plain`, the counterpart of the
    reference's jnp `_flash_fwd_impl`, counted in `blockwise_calls`."""
    global blockwise_calls
    dk, dv = q.shape[-1], v.shape[-1]
    if (dk, dv) not in fa.HEAD_DIMS and dk % 128:
        with _BLOCKWISE_LOCK:
            blockwise_calls += 1
        return fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            window=window)[0]
    out, _ = fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a cache. q: (B, Hq, 1, dk); caches
    (B, Hkv, S_max, d*); the new token is already written at `pos`."""
    B, Hq, _, dk = q.shape
    Hkv, S_max = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, 1, dk)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     k_cache.float()) * dk ** -0.5
    k_pos = torch.arange(S_max, device=q.device)
    mask = k_pos <= pos
    if window:
        mask &= k_pos > pos - window
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, Hq, 1, v_cache.shape[-1]).to(q.dtype)


class Attention(nn.Module):
    """GQA self-attention weights with ghost-head padding
    (cfg.tp_pad_heads): physical head counts are padded, and the ghost wq
    columns and wo rows are zero, so the block's output equals the
    unpadded block's. Built with a generator it is the reference's
    `init_attention`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        hqp, hkvp = cfg.num_heads_padded, cfg.num_kv_heads_padded
        dev = gen.device if gen is not None else torch.device(device)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.bfloat16,
                                            device=dev), requires_grad=False)
        self.wq = zeros(d, hqp * hd)
        self.wk = zeros(d, hkvp * hd)
        self.wv = zeros(d, hkvp * hd)
        self.wo = zeros(hqp * hd, d)
        if cfg.qkv_bias:
            self.bq = zeros(hqp * hd)
            self.bk = zeros(hkvp * hd)
            self.bv = zeros(hkvp * hd)
        if gen is not None:                 # init_attention
            s = d ** -0.5
            self.wq[:, :hq * hd] = _normal(gen, (d, hq * hd), s)
            self.wk[:, :hkv * hd] = _normal(gen, (d, hkv * hd), s)
            self.wv[:, :hkv * hd] = _normal(gen, (d, hkv * hd), s)
            self.wo[:hq * hd] = _normal(gen, (hq * hd, d), (hq * hd) ** -0.5)


def attention_block(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                    mode: str, cache: dict | None,
                    pos: int | None) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D). Returns (attn_out, new_cache). Full attention only:
    local attention's window caches come with ROADMAP A9. In decode mode
    the new token's k/v are written into `cache` in place (the reference
    returns updated copies), and the same tensors come back as the new
    cache."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads_padded, cfg.num_kv_heads_padded
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = q.reshape(B, S, hq, hd).transpose(1, 2)
    k = k.reshape(B, S, hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, hkv, hd).transpose(1, 2)

    if mode == "decode":
        where = torch.arange(pos, pos + 1, device=x.device)
        q = apply_rope(q, where, cfg.rope_theta)
        k = apply_rope(k, where, cfg.rope_theta)
        k_cache = _write_cache(cache["k"], k, pos)
        v_cache = _write_cache(cache["v"], v, pos)
        out = decode_attention(q, k_cache, v_cache, pos)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=cfg.causal)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None

    out = out.transpose(1, 2).reshape(B, S, hq * hd)
    return out @ params.wo, new_cache


def _write_cache(cache_arr: torch.Tensor, new: torch.Tensor,
                 slot: int) -> torch.Tensor:
    """cache: (B, H, S_max, hd); new: (B, H, 1, hd). Writes in place."""
    cache_arr[:, :, slot:slot + 1] = new.to(cache_arr.dtype)
    return cache_arr
