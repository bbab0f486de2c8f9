"""Neural blocks of the port (port of `repro.models.layers`).

The `attn` and `local_attn` block kinds: RMSNorm, rotary embeddings, GQA
self-attention with ghost-head padding (windowed, with a rotating window
cache, for `local_attn`), SwiGLU; the `mla` kind's multi-head latent
attention (per-head form over the call's own tokens, absorbed form in
decode, latent cache); the `attn_moe` kind's MoE FFN
(token-choice top-k routing with per-row expert capacity, a Switch
load-balance loss); the `mla_moe` kind's MLA (with YaRN for a
`YarnMLAConfig`) and its dropless MoE for a `RoutedMoEConfig` (sigmoid
scores, a correction bias, the held experts' share as grouped GEMMs, a
shared expert); the `rg` kind's Griffin recurrent block (RG-LRU); the
`rwkv` kind's RWKV6 time-mix (chunked WKV scan, exact one-step decode) and
channel-mix; and the `cross_attn` kind's gated cross-attention over stub
vision embeddings.
Activations are bf16, statistics (norms, softmax, the router, the
recurrence) accumulate in fp32, as in the reference. Weights keep the
reference's layout (`x @ W`, W of shape (in, out)) so that a parameter
tree means the same bytes in both packages.

Attention in train and prefill mode routes by shape, as the reference's
`_flash_fn` does: head dims the flash kernel is built for
(`kernels.flash_attention.HEAD_DIMS`) and those that are multiples of 128
go through its wrapper (the hand-written CUDA kernel on the card, its
plain version on the CPU); every other head dim takes the kernel's plain
blockwise forward, the counterpart of the reference's jnp
`_flash_fwd_impl`, on either device. MLA attends over the call's own
tokens in the per-head form, its widths zero-padded to a kernel instance
(the reference attends on the absorbed latent, 288 / 256, in jnp). Where
autograd records the call, the backward is `flash_attention_bwd`, the
reference's blockwise jnp `_flash_bwd_impl` in PyTorch (the reference has
no Pallas backward). Decode attends one token against the cache with
plain tensor ops, as the reference does with einsums; cross-attention
decode goes through `flash_attention` (Sq = 1, not causal), as the
reference's does.
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.kernels import flash_attention as fa

from . import partitioning as PT
from .config import (MLAConfig, ModelConfig, MoEConfig, RoutedMoEConfig,
                     YarnMLAConfig, _rg_width)


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


def yarn_mscale(factor: float, m: float) -> float:
    """YaRN's g(s, m) = 0.1 m ln s + 1 (1 for s <= 1)."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


@functools.lru_cache(maxsize=None)
def yarn_freqs(dim: int, theta: float, c: YarnMLAConfig,
               device: torch.device) -> tuple[torch.Tensor, float]:
    """YaRN's rotary table over `dim` rotary dims, as DeepSeek-V3's
    `DeepseekV3YarnRotaryEmbedding` computes it (fp64, then fp32), with
    s = `rope_factor` and L0 = `original_max_position`:

    - f_i = theta^(-2i / dim), i = 0 .. dim / 2 - 1;
    - c(beta) = dim ln(L0 / (2 pi beta)) / (2 ln theta); low =
      floor(c(beta_fast)), high = ceil(c(beta_slow)), each clamped to
      [0, dim - 1]; where they are equal, high + 0.001;
    - ramp_i = clamp((i - low) / (high - low), 0, 1);
    - inv_freq_i = f_i / s ramp_i + f_i (1 - ramp_i);
    - cos and sin times g(s, mscale) / g(s, mscale_all_dim)
      (`yarn_mscale`).

    Kimi K2 (dim 64, theta 50,000, s 32, L0 4,096, both betas 1): low 19
    and high 20, so pairs 0-19 keep f_i and pairs 20-31 take f_i / 32;
    the factor is 1. -> (inv_freq (dim / 2,) on `device`, the factor).
    Cached as `_rope_freqs` is; callers must not modify it."""
    s, base = c.rope_factor, float(theta)

    def corr(beta: float) -> float:
        return dim * math.log(c.original_max_position / (2 * math.pi * beta)) \
            / (2 * math.log(base))
    low = max(math.floor(corr(c.beta_fast)), 0)
    high = min(math.ceil(corr(c.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    f = 1.0 / (base ** (np.arange(0, dim, 2) / dim))
    ramp = np.clip((np.arange(dim // 2) - low) / (high - low), 0.0, 1.0)
    inv = f / s * ramp + f * (1.0 - ramp)
    factor = yarn_mscale(s, c.mscale) / yarn_mscale(s, c.mscale_all_dim)
    return torch.from_numpy(inv.astype(np.float32)).to(device), factor


def mla_softmax_scale(c: MLAConfig) -> float:
    """MLA attention's softmax scale: (qk_nope + qk_rope)^-1/2, times
    g(s, mscale_all_dim)^2 under YaRN where mscale_all_dim is set
    (DeepSeek-V3's `softmax_scale`; Kimi K2: 192^-1/2 x 1.34657^2)."""
    scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
    if isinstance(c, YarnMLAConfig) and c.mscale_all_dim:
        scale *= yarn_mscale(c.rope_factor, c.mscale_all_dim) ** 2
    return scale


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn: YarnMLAConfig | None = None) -> torch.Tensor:
    """x: (..., S, hd); positions: (S,). Half-split rotation in fp32; with
    `yarn`, at YaRN's frequencies and cos / sin factor (`yarn_freqs`)."""
    hd = x.shape[-1]
    if yarn is None:
        freqs, factor = _rope_freqs(hd, theta, x.device), 1.0
    else:
        freqs, factor = yarn_freqs(hd, theta, yarn, x.device)
    angles = positions.float()[..., None] * freqs            # (S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if factor != 1.0:
        cos, sin = cos * factor, sin * factor
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """bf16 weights drawn as fp32 normals times `scale`."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Sharding on a device mesh
# ---------------------------------------------------------------------------
#
# With `mesh=None` (every path but the sharded ones) each function below
# returns its input untouched, so the unsharded model runs the same ops as
# before. With a `DeviceMesh` the model's parameters and activations are
# DTensors: `cst` pins an activation's placements where the reference's
# `cst` pins its sharding, and DTensor's sharding propagation inserts the
# collectives between. Where it cannot shard an op (attention, the MoE
# routing and capacity dispatch, the WKV and RG-LRU scans, the embedding
# gather, the loss, shifts along the sequence), or shards it at a cost
# the reference does not pay (the row-parallel products), the block's
# math runs on each device's local shards in a `local_map` region whose
# placements are the reference's.

def _cst_placements(shape: tuple, mesh, spec: tuple) -> tuple:
    """The placements of `cst(x, mesh, *spec)` for an x of `shape`."""
    ba = PT.batch_axes(mesh)
    spec = tuple(ba if ax == "B" else ax for ax in spec)
    return PT.placements(PT._guard(spec, tuple(shape), mesh), mesh)


def cst(x: torch.Tensor, mesh, *spec) -> torch.Tensor:
    """Activation sharding constraint (Megatron pattern), the reference's
    `cst`: x (a DTensor) redistributed to `spec`, whose entries are "B"
    (the batch axes, ("pod", "data") when present), an axis name or None;
    axes absent from the mesh or not dividing the dim are dropped. Without
    a mesh, x itself."""
    if mesh is None:
        return x
    pl = _cst_placements(tuple(x.shape), mesh, spec)
    if x.requires_grad and torch.is_grad_enabled():
        return _Pin.apply(x, mesh, pl)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


class _Pin(torch.autograd.Function):
    """`cst` under autograd: the activation and its gradient both take the
    pinned placements, as a sharding constraint binds a value and its
    cotangent in the reference. (A gradient left to DTensor may arrive
    with its rows split over `model` where the forward split none, and a
    flattened strided split is one DTensor's matmul strategies cannot
    place.)"""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.pin = (mesh, pl)
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.pin
        return (g if tuple(g.placements) == pl else g.redistribute(mesh, pl),
                None, None)


def _axis(mesh, name: str) -> tuple[int, int]:
    """(this rank's coordinate, size) on mesh axis `name`; (0, 1) when the
    mesh has no such axis."""
    if name not in mesh.mesh_dim_names:
        return 0, 1
    return (mesh.get_local_rank(name),
            mesh.shape[mesh.mesh_dim_names.index(name)])


def _partial_on(pl: tuple, mesh, names) -> tuple:
    """`pl` with `Partial()` on the mesh axes `names` where it replicates:
    the gradient placements of an input that every rank on those axes
    reads whole but uses with its own shard of the batch (or of the
    experts, or of the heads)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if n in names and isinstance(p, Replicate) else p
                 for n, p in zip(mesh.mesh_dim_names, pl))


def _on_shards(fn, mesh, args: tuple, in_pl: tuple, out_pl,
               grad_pl: tuple | None = None):
    """fn(*local shards) under `local_map`: each DTensor argument is
    redistributed to its `in_pl` entry (None for a non-tensor) and handed
    over as this rank's local tensor; the outputs come back as DTensors of
    `out_pl`. `grad_pl` gives the placements of the arguments' gradients
    where they differ from `in_pl`."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    # one output: a list of placements; several: a tuple of them
    out_pl = (list(out_pl) if all(isinstance(p, Placement) for p in out_pl)
              else tuple(list(p) for p in out_pl))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _along_seq(fn, mesh, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for an op along the sequence (a shift, a pad, a roll), which
    no mesh splits: on a mesh, fn of each device's shard."""
    if mesh is None:
        return fn(x)
    pl = tuple(x.placements)
    return _on_shards(fn, mesh, (x,), (pl,), pl)


def _reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """All-reduce of a local tensor over `group` (functional collective:
    traceable under fake tensors)."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(t, op, group)
    return out.wait() if hasattr(out, "wait") else out


def _row_parallel(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """x @ w for a row-parallel weight w (its rows over `model`), pinned
    to (B, None, None) as the reference's `cst` pins the product. On a
    mesh each device multiplies its columns of x by its rows of w (w whole
    over the batch axes, its gradient a partial sum there) and the
    partial products are summed over `model`. (Left to DTensor, the
    backward's dgrad gathers w whole over `model` and repeats the product
    on every device of the group: 16x its FLOPs on the production mesh.)"""
    if mesh is None:
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    xpl = _cst_placements(tuple(x.shape), mesh, ("B", None, "model"))
    split = Shard(x.dim() - 1) in xpl
    wpl = tuple(Shard(0) if n == "model" and split else Replicate()
                for n in mesh.mesh_dim_names)
    opl = tuple(Partial() if p == Shard(x.dim() - 1) else p for p in xpl)
    out = _on_shards(torch.matmul, mesh, (x, w), (xpl, wpl), opl,
                     (xpl, _partial_on(wpl, mesh, PT.batch_axes(mesh))))
    return cst(out, mesh, "B", None, None)


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

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        gate = x @ self.w_gate
        up = x @ self.w_up
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        act = cst(act, mesh, "B", None, "model")
        return _row_parallel(act, self.w_down, mesh)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

blockwise_calls = 0      # flash_attention calls routed off the kernel
mla_per_head_calls = 0   # MLA attention calls in the per-head form
_BLOCKWISE_LOCK = threading.Lock()


def reset_blockwise_calls() -> None:
    global blockwise_calls
    with _BLOCKWISE_LOCK:
        blockwise_calls = 0


def reset_mla_per_head_calls() -> None:
    global mla_per_head_calls
    with _BLOCKWISE_LOCK:
        mla_per_head_calls = 0


def _chunk(size: int, target: int = 1024) -> int:
    """The largest divisor of `size` up to `target` (the reference's
    `_chunk`, which picks RWKV's scan chunk)."""
    c = min(size, target)
    while size % c:
        c -= 1
    return c


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, fp32 lse) through the route of `flash_attention`: blockwise
    for head dims the kernels lack (`fa.flash_attention_blockwise`: the
    block loop, or for a fake tensor one traced operator), else
    `fa.flash_attention_fwd`, whose
    own route sends bf16 calls of at most `fa.DECODE_ROWS` rows a kv head
    (Hq / Hkv x Sq: the cross-attention decode step) to the split-KV
    decode kernel and every other call to the prefill kernel of its
    dtype. Names the route on the open `attention` span."""
    global blockwise_calls
    dk, dv = q.shape[-1], v.shape[-1]
    span = obs.current()
    if (dk, dv) not in fa.HEAD_DIMS and dk % 128:
        with _BLOCKWISE_LOCK:
            blockwise_calls += 1
        if span is not None:
            span.set(route="blockwise")
        return fa.flash_attention_blockwise(q, k, v, causal=causal,
                                            window=window)
    if span is not None:
        decode = fa.is_decode(q, k)
        span.set(route=("decode" if decode else "kernel") if q.is_cuda
                 else ("decode_plain" if decode else "plain"))
    return fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)


class _FlashAttention(torch.autograd.Function):
    """The flash forward with the blockwise backward: saves q, k, v, out
    and lse, nothing of Sq x Skv elements."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, mesh=None) -> torch.Tensor:
    """q: (B, Hq, Sq, dk), k: (B, Hkv, Skv, dk), v: (B, Hkv, Skv, dv) ->
    (B, Hq, Sq, dv), differentiable in q, k and v. Routed as the
    reference's `_flash_fn` routes: (dk, dv) in `fa.HEAD_DIMS` (64, 128
    and 256), and every dk that is a multiple of 128, go to the flash
    kernel's wrapper, which raises on the card for a pair it lacks and
    sends bf16 calls of at most `fa.DECODE_ROWS` rows a kv head (a decode
    step) to the split-KV decode kernel (`flash_decode_plain` on the
    CPU), the rest to the prefill kernel; every
    other head dim takes the blockwise forward
    `fa.flash_attention_fwd_plain`, the counterpart of the reference's
    jnp `_flash_fwd_impl`, counted in `blockwise_calls`. The backward is
    `flash_attention_bwd`, the reference's `_flash_bwd_impl`; it runs
    only where autograd records the call (an input requires grad and
    grad mode is on), so under `torch.no_grad` or `inference_mode` the
    call is the forward alone and saves nothing. With a mesh, q, k and v
    are DTensors placed by `_shard_attn_heads`, and each device attends
    its own shards (`_flash_on_shards`). Recorded as the span
    `attention` (with a mesh, each shard's call), its route an attr
    (`repro_torch.obs`)."""
    if mesh is not None:
        return _flash_on_shards(q, k, v, causal, window, mesh)
    with obs.span("attention"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, bool(causal), int(window))
        return _flash_forward(q, k, v, causal, window)[0]


def _whole_heads(x: torch.Tensor, mesh, heads: int) -> torch.Tensor:
    """x (B, S, H x hd), pinned by the reference's `cst` over `model`
    wherever that divides H x hd, which may cut a head: a DTensor split
    that cuts a head cannot become a split of the heads, so such an x is
    gathered over `model` before it is viewed as heads."""
    if mesh is None or heads % PT.axis_sizes(mesh).get("model", 1) == 0:
        return x
    return cst(x, mesh, "B", None, None)


def _shard_attn_heads(mesh, q, k, v):
    """Pin the attention-internal placements (B, H, S, hd), the
    reference's `_shard_attn_heads`: heads over `model` where the head
    count divides it (k and v whose kv heads do not divide it fall back to
    replicated heads, per tensor, as `cst` drops the axis), else the batch
    alone."""
    if mesh is None:
        return q, k, v
    spec = (("B", "model", None, None)
            if q.shape[1] % PT.axis_sizes(mesh).get("model", 1) == 0
            else ("B", None, None, None))
    return tuple(cst(t, mesh, *spec) for t in (q, k, v))


def _flash_on_shards(q, k, v, causal: bool, window: int, mesh):
    """`flash_attention` on each device's shards (the kernel on the card):
    q, k and v split alike (batch, and heads or not), or q's heads over
    `model` with k and v whole, in which case each device attends with the
    kv heads its q heads read, and the k, v gradients are partial sums
    over `model`."""
    def attend(q, k, v):
        return flash_attention(q, k, v, causal=causal, window=window)
    qpl, kpl = tuple(q.placements), tuple(v.placements)
    if tuple(k.placements) != kpl:
        k = k.redistribute(mesh, kpl)
    if qpl == kpl:
        return _on_shards(attend, mesh, (q, k, v), (qpl, kpl, kpl), qpl)
    r, m = _axis(mesh, "model")
    hq_l, group = q.shape[1] // m, q.shape[1] // k.shape[1]
    if hq_l % group and group % hq_l:        # no clean head map: batch only
        q = q.redistribute(mesh, kpl)
        return _on_shards(attend, mesh, (q, k, v), (kpl, kpl, kpl), kpl)
    h0, nk = r * hq_l // group, max(1, hq_l // group)

    def attend_heads(q, k, v):
        return attend(q, k[:, h0:h0 + nk], v[:, h0:h0 + nk])
    gpl = _partial_on(kpl, mesh, ("model",))
    return _on_shards(attend_heads, mesh, (q, k, v), (qpl, kpl, kpl), qpl,
                      (qpl, gpl, gpl))


def _pair_mask(q0: int, nq: int, k0: int, nk: int, causal: bool,
               window: int, device) -> torch.Tensor | bool | None:
    """The mask of one (q chunk, kv chunk) pair: None when every pair is
    visible, False when none is, else a (nq, nk) bool tensor."""
    lo = q0 - (k0 + nk - 1)         # smallest q_pos - k_pos in the block
    hi = q0 + nq - 1 - k0           # largest
    if (causal and hi < 0) or (window and lo >= window):
        return False
    if (not causal or lo >= 0) and (not window or hi < window):
        return None
    qp = torch.arange(q0, q0 + nq, device=device)[:, None]
    kp = torch.arange(k0, k0 + nk, device=device)[None]
    mask = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    return mask


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashAttention-2 backward, the reference's `_flash_bwd_impl` in
    PyTorch: p-blocks recomputed from (q, k, lse); an outer loop over kv
    chunks accumulates their dk, dv, an inner loop over q chunks adds each
    pair's share of dq. Chunks are 1024 long with a ragged tail (the
    reference's `_chunk(S, 1024)` divides S, which at the vision length
    6404 = 4 x 1601 is 4; the sums do not depend on the chunking).
    D = rowsum(dO * O) in fp32; p and ds are rounded to the io dtype before their products,
    and every product accumulates in fp32 (its operands are taken to fp32
    first: a product of two bf16 values is exact in fp32, as the
    reference's `preferred_element_type=float32` keeps it). Pairs that
    the causal or window mask hides entirely are skipped, as the
    reference's "bounded" schedule skips them: their shares are zero.
    lse: (B, Hq, Sq) fp32.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Hq, Sq, dk_dim = q.shape
    Hkv, Skv, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = dk_dim ** -0.5
    qc, kc = min(Sq, 1024), min(Skv, 1024)
    io, f32, dev = q.dtype, torch.float32, q.device

    qg = q.reshape(B, Hkv, G, Sq, dk_dim)
    dog = dout.reshape(B, Hkv, G, Sq, dv_dim)
    Dvec = (dog.to(f32) * out.reshape(B, Hkv, G, Sq, dv_dim).to(f32)).sum(-1)
    lse = torch.where(torch.isfinite(lse), lse, 0.0).reshape(B, Hkv, G, Sq)
    dq = torch.zeros((B, Hkv, G, Sq, dk_dim), dtype=f32, device=dev)
    dkf = torch.zeros((B, Hkv, Skv, dk_dim), dtype=f32, device=dev)
    dvf = torch.zeros((B, Hkv, Skv, dv_dim), dtype=f32, device=dev)
    for k0 in range(0, Skv, kc):
        ks = k[:, :, k0:k0 + kc].to(f32)
        vs = v[:, :, k0:k0 + kc].to(f32)
        dkj, dvj = dkf[:, :, k0:k0 + kc], dvf[:, :, k0:k0 + kc]
        nk = min(kc, Skv - k0)
        for q0 in range(0, Sq, qc):
            mask = _pair_mask(q0, min(qc, Sq - q0), k0, nk, causal, window,
                              dev)
            if mask is False:
                continue
            rows = slice(q0, q0 + qc)
            qx = qg[:, :, :, rows].to(f32)
            do = dog[:, :, :, rows].to(f32)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qx, ks).mul_(scale)
            p = s.sub_(lse[:, :, :, rows, None]).exp_()
            if mask is not None:
                p.masked_fill_(~mask, 0.0)
            dvj += torch.einsum("bhgqk,bhgqd->bhkd", p.to(io).to(f32), do)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vs)
            ds = p.mul_(dp.sub_(Dvec[:, :, :, rows, None])).to(io).to(f32)
            dq[:, :, :, rows] += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                              ks).mul_(scale)
            dkj += torch.einsum("bhgqk,bhgqd->bhkd", ds, qx).mul_(scale)
    return (dq.reshape(B, Hq, Sq, dk_dim).to(q.dtype), dkf.to(k.dtype),
            dvf.to(v.dtype))


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
                    mode: str, cache: dict | None, pos: int | None, *,
                    window: int = 0, mesh=None
                    ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D). Returns (attn_out, new_cache). With `window` (the
    `local_attn` kind) queries see the last `window` keys, and the cache
    is a rotating window: position p lives in slot p % window. In decode
    mode the new token's k/v are written into `cache` in place (the
    reference returns updated copies), and the same tensors come back as
    the new cache. With a mesh, decode runs `_decode_on_shards` against a
    cache placed by `partitioning.cache_shardings`."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads_padded, cfg.num_kv_heads_padded
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = _whole_heads(cst(q, mesh, "B", None, "model"), mesh, hq)
    k = _whole_heads(cst(k, mesh, "B", None, "model"), mesh, hkv)
    v = _whole_heads(cst(v, mesh, "B", None, "model"), mesh, hkv)
    q = q.reshape(B, S, hq, hd).transpose(1, 2)
    k = k.reshape(B, S, hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, hkv, hd).transpose(1, 2)

    if mode == "decode":
        where = torch.arange(pos, pos + 1, device=x.device)
        q = apply_rope(q, where, cfg.rope_theta)
        k = apply_rope(k, where, cfg.rope_theta)
        if mesh is not None:
            out = _decode_on_shards(mesh, q, k, v, cache["k"], cache["v"],
                                    pos, window)
            new_cache = {"k": cache["k"], "v": cache["v"]}
        else:
            slot = pos % window if window else pos
            k_cache = _write_cache(cache["k"], k, slot)
            v_cache = _write_cache(cache["v"], v, slot)
            if window:
                out = _decode_window(q, k_cache, v_cache, pos, window)
            else:
                out = decode_attention(q, k_cache, v_cache, pos)
            new_cache = {"k": k_cache, "v": v_cache}
    else:
        q, k, v = _shard_attn_heads(mesh, q, k, v)
        positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                              mesh=mesh)
        new_cache = None
        if mode == "prefill" and window:
            keep = min(window, S)
            new_cache = {name: _along_seq(
                lambda t: _roll_tail(t, keep, window), mesh, t)
                for name, t in (("k", k), ("v", v))}
        elif mode == "prefill":
            new_cache = {"k": k, "v": v}

    out = out.transpose(1, 2).reshape(B, S, hq * hd)
    out = cst(out, mesh, "B", None, "model")
    return _row_parallel(out, params.wo, mesh), new_cache


def _cache_layout(mesh, cache: torch.Tensor, seq_dim: int
                  ) -> tuple[tuple, tuple, int, int]:
    """(the cache's placements, those of the decode step's other inputs:
    the cache's batch split and nothing else, this rank's coordinate and
    the split count along the cache's sequence dim). A decode cache is
    split as `partitioning.cache_shardings` splits it: batch over the
    batch axes, the sequence over `model`."""
    from torch.distributed.tensor import Replicate, Shard
    cpl = tuple(cache.placements)
    if any(p not in (Replicate(), Shard(0), Shard(seq_dim)) for p in cpl):
        raise ValueError(f"decode cache placed {cpl}; place it with "
                         f"partitioning.cache_shardings")
    bpl = tuple(p if p == Shard(0) else Replicate() for p in cpl)
    split = Shard(seq_dim) in cpl
    r, m = _axis(mesh, "model") if split else (0, 1)
    return cpl, bpl, r, m


def _decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, keep: torch.Tensor,
                    group) -> torch.Tensor:
    """Single-token attention against this rank's slice of a cache split
    along its sequence (flash-decoding): fp32 scores of the visible slots
    (`keep`), then the max, the exp-sum and the weighted values combined
    over `group`."""
    B, Hq, _, dk = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, 1, dk)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     k_cache.float()) * dk ** -0.5
    s = torch.where(keep, s, -torch.inf)
    mx = _reduce(s.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(s - mx)
    den = _reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    acc = _reduce(torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.float()),
                  "sum", group)
    return (acc / den).reshape(B, Hq, 1, v_cache.shape[-1]).to(q.dtype)


def _visible(pos: int, window: int, off: int, n: int, device
             ) -> torch.Tensor:
    """Which of the cache slots off .. off + n - 1 a decode step at `pos`
    sees: positions up to pos, or for a rotating window cache the slots
    whose age is under the window (`_decode_window`'s rule)."""
    j = torch.arange(off, off + n, device=device)
    if window:
        return (pos % window - j) % window <= min(pos, window - 1)
    return j <= pos


def _decode_on_shards(mesh, q, k, v, k_cache, v_cache, pos: int,
                      window: int) -> torch.Tensor:
    """The decode step of `attention_block` on each device's shards: the
    new k, v written into the slice of the cache that holds slot `pos`
    (in place), then the step's attention: `decode_attention` /
    `_decode_window` where the sequence is whole, else `_decode_partial`
    over `model`."""
    cpl, bpl, r, m = _cache_layout(mesh, k_cache, 2)
    group = mesh.get_group("model") if m > 1 else None
    slot = pos % window if window else pos

    def step(q, k, v, kc, vc):
        n = kc.shape[2]
        off = r * n
        if off <= slot < off + n:
            _write_cache(kc, k, slot - off)
            _write_cache(vc, v, slot - off)
        if m == 1:
            return (_decode_window(q, kc, vc, pos, window) if window
                    else decode_attention(q, kc, vc, pos))
        return _decode_partial(q, kc, vc,
                               _visible(pos, window, off, n, q.device), group)
    return _on_shards(step, mesh, (q, k, v, k_cache, v_cache),
                      (bpl, bpl, bpl, cpl, cpl), bpl)


def _write_cache(cache_arr: torch.Tensor, new: torch.Tensor,
                 slot: int) -> torch.Tensor:
    """cache: (B, H, S_max, hd); new: (B, H, 1, hd). Writes in place."""
    cache_arr[:, :, slot:slot + 1] = new.to(cache_arr.dtype)
    return cache_arr


def _roll_tail(kv: torch.Tensor, keep: int, window: int) -> torch.Tensor:
    """The last `keep` entries of kv (B, H, S, hd) as a rotating window
    cache of `window` slots, zero-padded, in which position p sits in slot
    p % window."""
    B, H, S, hd = kv.shape
    tail = kv[:, :, S - keep:]
    if keep < window:
        tail = F.pad(tail, (0, 0, 0, window - keep))
    # the global position of tail[j] is S - keep + j
    return torch.roll(tail, shifts=(S - keep) % window, dims=2)


def _decode_window(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos: int,
                   window: int) -> torch.Tensor:
    """Single-token attention against a rotating window cache: slot j
    holds the position p with p % window == j, pos - window < p <= pos,
    so slots are compared by their age (pos - p), not by position."""
    B, Hq, _, dk = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, 1, dk)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     k_cache.float()) * dk ** -0.5
    j = torch.arange(window, device=q.device)
    age = (pos % window - j) % window
    s = torch.where(age <= min(pos, window - 1), s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, Hq, 1, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek)
# ---------------------------------------------------------------------------
#
# The decode cache holds only the latent `ckv` and the shared rotary key
# `kr`. A decode step attends in the absorbed form: with W_uk absorbed into
# the query and W_uv applied after attention, MLA is MQA with one key head
# of kv_lora + rope (288) and one value head of kv_lora (256) over the
# latent. Over the call's own tokens (train, prefill) the keys are as many
# as the queries, so the up-projection of K and V costs what the absorption
# of q and out would, and the per-head form attends at nope + rope (96) and
# v (64) instead: 3.4 x fewer operations a (query, key) pair and head, on
# a flash kernel instance.

class MLA(nn.Module):
    """The MLA weights: the query's down-projection `w_dq` (d, q_lora),
    its norm `q_norm` and up-projection `w_uq` (q_lora, H x qk_head); the
    joint latent + rotary-key projection `w_dkv` (d, kv_lora + rope) and
    the latent's norm `kv_norm`; the per-head absorptions `w_uk` (H, nope,
    kv_lora) and `w_uv` (H, kv_lora, v); `wo` (H x v, d). H is the padded
    head count (cfg.tp_pad_heads): the ghost heads' `w_uq` columns, `w_uk`
    and `w_uv` slices and `wo` rows are zero. Built with a generator it is
    the reference's `init_mla`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        c, d, H = cfg.mla, cfg.d_model, cfg.num_heads
        Hp = cfg.num_heads_padded
        qk = c.qk_nope_head_dim + c.qk_rope_head_dim
        dev = gen.device if gen is not None else torch.device(device)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.bfloat16,
                                            device=dev), requires_grad=False)

        def ones(n):
            return nn.Parameter(torch.ones((n,), dtype=torch.bfloat16,
                                           device=dev), requires_grad=False)
        self.w_dq = zeros(d, c.q_lora_rank)
        self.q_norm = ones(c.q_lora_rank)
        self.w_uq = zeros(c.q_lora_rank, Hp * qk)
        self.w_dkv = zeros(d, c.kv_lora_rank + c.qk_rope_head_dim)
        self.kv_norm = ones(c.kv_lora_rank)
        self.w_uk = zeros(Hp, c.qk_nope_head_dim, c.kv_lora_rank)
        self.w_uv = zeros(Hp, c.kv_lora_rank, c.v_head_dim)
        self.wo = zeros(Hp * c.v_head_dim, d)
        if gen is not None:                 # init_mla
            s = d ** -0.5
            self.w_dq[:] = _normal(gen, (d, c.q_lora_rank), s)
            self.w_uq[:, :H * qk] = _normal(gen, (c.q_lora_rank, H * qk),
                                            c.q_lora_rank ** -0.5)
            self.w_dkv[:] = _normal(
                gen, (d, c.kv_lora_rank + c.qk_rope_head_dim), s)
            self.w_uk[:H] = _normal(
                gen, (H, c.qk_nope_head_dim, c.kv_lora_rank),
                c.qk_nope_head_dim ** -0.5)
            self.w_uv[:H] = _normal(gen, (H, c.kv_lora_rank, c.v_head_dim),
                                    c.kv_lora_rank ** -0.5)
            self.wo[:H * c.v_head_dim] = _normal(
                gen, (H * c.v_head_dim, d), (H * c.v_head_dim) ** -0.5)


def mla_block(params: MLA, x: torch.Tensor, cfg: ModelConfig, mode: str,
              cache: dict | None, pos: int | None, mesh=None
              ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D). Returns (out, new_cache). Where the keys are the
    call's own tokens (train, prefill) attention runs in the per-head
    form (`_mla_heads`): W_uk and W_uv applied to the latent, each head's
    q = [q_nope | q_rope], k = [k_nope | k_rope] and v zero-padded to the
    smallest square kernel instance, one `flash_attention` call (counted
    in `mla_per_head_calls`); the cache it returns is the latent
    {"ckv", "kr"}. In decode mode it runs on the absorbed latent: q
    (B, H, 1, kv_lora + rope) against one key head concat(ckv, kr) and one
    value head ckv of the latent cache, whose `ckv` and `kr` (B, S_max, *)
    get the new token at `pos` in place (the same tensors come back as the
    new cache), through `decode_attention`. q is scaled in bf16 by the
    softmax scale (`mla_softmax_scale`: qk_head^-0.5, and YaRN's factor
    for a `YarnMLAConfig`) then sqrt(attention's head dim), two roundings
    as in the reference, so that attention's own head-dim^-0.5 leaves the
    per-head scale. A `YarnMLAConfig` rotates at YaRN's frequencies
    (`yarn_freqs`) in both forms."""
    global mla_per_head_calls
    c = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads_padded
    qk = c.qk_nope_head_dim + c.qk_rope_head_dim
    yarn = c if isinstance(c, YarnMLAConfig) else None
    scale = mla_softmax_scale(c)

    # the latents whole on every device (their gradients too: `cst`)
    ql = rms_norm(cst(x @ params.w_dq, mesh, "B", None, None),
                  params.q_norm, cfg.rms_eps)
    q = (ql @ params.w_uq).reshape(B, S, H, qk)
    q_nope = q[..., :c.qk_nope_head_dim]
    q_rope = q[..., c.qk_nope_head_dim:].transpose(1, 2)    # (B, H, S, r)
    dkv = cst(x @ params.w_dkv, mesh, "B", None, None)
    ckv = rms_norm(dkv[..., :c.kv_lora_rank], params.kv_norm, cfg.rms_eps)
    k_rope = dkv[..., c.kv_lora_rank:][:, None]             # (B, 1, S, r)

    if mode == "decode":
        # absorb W_uk: q_lat (B, H, S, kv_lora), bf16 as the reference's
        q_lat = torch.einsum("bshn,hnr->bhsr", q_nope, params.w_uk)
        where = torch.arange(pos, pos + 1, device=x.device)
        q_rope = apply_rope(q_rope, where, cfg.rope_theta, yarn)
        k_rope = apply_rope(k_rope, where, cfg.rope_theta, yarn)[:, 0]
        ckv_cache, kr_cache = cache["ckv"], cache["kr"]
        qf = torch.cat([q_lat, q_rope], dim=-1)
        if mesh is not None:
            out = _mla_decode_on_shards(
                mesh, qf * scale * qf.shape[-1] ** 0.5, ckv, k_rope,
                ckv_cache, kr_cache, pos)
        else:
            ckv_cache[:, pos:pos + 1] = ckv.to(ckv_cache.dtype)
            kr_cache[:, pos:pos + 1] = k_rope.to(kr_cache.dtype)
            kf = torch.cat([ckv_cache, kr_cache], dim=-1)[:, None]
            out = decode_attention(qf * scale * qf.shape[-1] ** 0.5, kf,
                                   ckv_cache[:, None], pos)
        new_cache = {"ckv": ckv_cache, "kr": kr_cache}
        o = torch.einsum("bhsr,hrv->bshv", out, params.w_uv)
    else:
        positions = torch.arange(S, device=x.device)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta, yarn)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta, yarn)[:, 0]
        k_nope = torch.einsum("bsr,hnr->bshn", ckv, params.w_uk)
        v = torch.einsum("bsr,hrv->bshv", ckv, params.w_uv)
        qh, kh, vh = _mla_heads_on(mesh, q_nope, q_rope, k_nope, v, k_rope,
                                   scale)
        with _BLOCKWISE_LOCK:
            mla_per_head_calls += 1
        out = flash_attention(qh, kh, vh, causal=cfg.causal, mesh=mesh)
        o = out[..., :c.v_head_dim].transpose(1, 2)         # (B, S, H, v)
        new_cache = ({"ckv": ckv, "kr": k_rope} if mode == "prefill"
                     else None)

    o = o.reshape(B, S, H * c.v_head_dim)
    o = cst(o, mesh, "B", None, "model")
    return _row_parallel(o, params.wo, mesh), new_cache


def mla_head_dim(qk: int, v: int) -> int:
    """The per-head form's padded head dim: the smallest D with (D, D) a
    flash kernel instance (`fa.HEAD_DIMS`) and D >= both widths."""
    for dk, dv in sorted(fa.HEAD_DIMS):
        if dk == dv >= max(qk, v):
            return dk
    raise ValueError(f"no flash kernel instance takes MLA's per-head dims "
                     f"(q, k {qk}, v {v}); built for {fa.HEAD_DIMS}")


def _mla_heads(q_nope: torch.Tensor, q_rope: torch.Tensor,
               k_nope: torch.Tensor, v: torch.Tensor, k_rope: torch.Tensor,
               scale: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLA's per-head attention inputs, each (B, H, S, D) with D
    `mla_head_dim`: q = [q_nope | q_rope] scaled by `scale` and
    sqrt(D) (see `mla_block`),
    k = [k_nope | k_rope] (the rotary key shared by every head) and v,
    each written once into its buffer and zero past its width (zero
    columns add nothing to a dot product, so the attention is exact).
    q_nope, k_nope, v: (B, S, H, *); q_rope (B, H, S, r); k_rope (B, S, r).
    """
    B, S, H, nope = k_nope.shape
    qk, dv = nope + k_rope.shape[-1], v.shape[-1]
    D = mla_head_dim(qk, dv)
    qh, kh, vh = (v.new_empty((B, H, S, D)) for _ in range(3))
    qh[..., :nope] = q_nope.transpose(1, 2)
    qh[..., nope:qk] = q_rope
    kh[..., :nope] = k_nope.transpose(1, 2)
    kh[..., nope:qk] = k_rope[:, None]
    vh[..., :dv] = v.transpose(1, 2)
    for t, w in ((qh, qk), (kh, qk), (vh, dv)):
        t[..., w:] = 0
    return qh.mul_(scale).mul_(D ** 0.5), kh, vh


def _mla_heads_on(mesh, q_nope, q_rope, k_nope, v, k_rope, scale: float):
    """`_mla_heads`, on a mesh on each device's shards, its outputs placed
    as `_shard_attn_heads` places attention's: heads over `model` where
    their count divides it; the rotary key whole, its gradient then a
    partial sum over `model`."""
    if mesh is None:
        return _mla_heads(q_nope, q_rope, k_nope, v, k_rope, scale)
    B, S, H, _ = k_nope.shape
    split = H % PT.axis_sizes(mesh).get("model", 1) == 0
    by_s = ("B", None, "model" if split else None, None)
    by_h = ("B", "model" if split else None, None, None)
    in_pl = tuple(_cst_placements(tuple(t.shape), mesh, spec) for t, spec in
                  ((q_nope, by_s), (q_rope, by_h), (k_nope, by_s),
                   (v, by_s), (k_rope, ("B", None, None))))
    out_pl = _cst_placements((B, H, S, 1), mesh, by_h)
    grad_pl = in_pl[:4] + ((_partial_on(in_pl[4], mesh, ("model",))
                            if split else in_pl[4]),)
    return _on_shards(functools.partial(_mla_heads, scale=scale), mesh,
                      (q_nope, q_rope, k_nope, v, k_rope), in_pl,
                      (out_pl,) * 3, grad_pl)


def _mla_decode_on_shards(mesh, qf, ckv, kr, ckv_cache, kr_cache,
                          pos: int) -> torch.Tensor:
    """MLA's decode step on each device's shards of the latent cache
    (`_decode_on_shards` for one key head concat(ckv, kr) and one value
    head ckv): the new latent written at `pos`, then the attention of the
    scaled queries `qf`."""
    cpl, bpl, r, m = _cache_layout(mesh, ckv_cache, 1)
    group = mesh.get_group("model") if m > 1 else None

    def step(qf, ckv, kr, ckv_c, kr_c):
        n = ckv_c.shape[1]
        off = r * n
        if off <= pos < off + n:
            ckv_c[:, pos - off:pos - off + 1] = ckv.to(ckv_c.dtype)
            kr_c[:, pos - off:pos - off + 1] = kr.to(kr_c.dtype)
        kf = torch.cat([ckv_c, kr_c], dim=-1)[:, None]
        if m == 1:
            return decode_attention(qf, kf, ckv_c[:, None], pos)
        return _decode_partial(qf, kf, ckv_c[:, None],
                               _visible(pos, 0, off, n, qf.device), group)
    return _on_shards(step, mesh, (qf, ckv, kr, ckv_cache, kr_cache),
                      (bpl, bpl, bpl, cpl, cpl), bpl)


# ---------------------------------------------------------------------------
# MoE FFN: token-choice top-k routing, per-(batch row, expert) capacity
# ---------------------------------------------------------------------------

def moe_capacity(m: MoEConfig, tokens_per_row: int) -> int:
    """Slots per (batch row, expert): the tokens' expected share times the
    capacity factor, rounded up to a multiple of 8 (at least 8), at most
    the row."""
    c = int(math.ceil(tokens_per_row * m.num_experts_per_tok
                      / m.num_experts * m.capacity_factor))
    c = max(8, (c + 7) // 8 * 8)
    return min(c, tokens_per_row)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, equal
    values in index order, as `jax.lax.top_k` orders them: a stable
    descending sort, sliced (`torch.topk` orders ties otherwise)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class MoE(nn.Module):
    """The MoE FFN's weights: the fp32 `router` (d, E), the stacked bf16
    experts `w_gate`, `w_up` (E, d, f) and `w_down` (E, f, d), and, with
    `num_shared_experts`, a `shared` SwiGLU of width d_ff_shared x that
    count. Built with a generator it is the reference's `init_moe`. A
    `RoutedMoEConfig` holds only its `held_experts` experts (the router
    keeps all E) and the fp32 `correction_bias` (E,), drawn last as
    0.01 N(0, 1)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        E, f = m.num_experts, m.d_ff_expert
        routed = isinstance(m, RoutedMoEConfig)
        held = m.held_experts if routed else E
        dev = gen.device if gen is not None else torch.device(device)

        def weight(*shape, scale):
            w = (_normal(gen, shape, scale) if gen is not None else
                 torch.empty(shape, dtype=torch.bfloat16, device=dev))
            return nn.Parameter(w, requires_grad=False)
        router = (torch.randn((d, E), generator=gen, device=dev) * d ** -0.5
                  if gen is not None else
                  torch.empty((d, E), dtype=torch.float32, device=dev))
        self.router = nn.Parameter(router, requires_grad=False)
        self.w_gate = weight(held, d, f, scale=d ** -0.5)
        self.w_up = weight(held, d, f, scale=d ** -0.5)
        self.w_down = weight(held, f, d, scale=f ** -0.5)
        if m.num_shared_experts:
            self.shared = SwiGLU(d, m.d_ff_shared * m.num_shared_experts,
                                 gen, dev)
        if routed:
            bias = (torch.randn((E,), generator=gen, device=dev) * 0.01
                    if gen is not None else
                    torch.empty((E,), dtype=torch.float32, device=dev))
            self.correction_bias = nn.Parameter(bias, requires_grad=False)


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig, mesh=None,
            train: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x: (B, S, D) -> (out (B, S, D), aux): the reference's `moe_ffn`.

    Each token picks its top K experts by fp32 router probability, their
    weights renormalised to sum 1; each (row, expert) keeps its top C
    tokens by weight (`moe_capacity`), the rest of its tokens are dropped
    for it. Both top-k steps take equal values in index order (`top_k`),
    as `jax.lax.top_k` does. The experts run as batched bf16 matmuls over
    the (E, B x C, D) dispatch. The combine is deterministic: each token
    adds its kept experts' weighted outputs in expert order, one bf16 add
    each, as the reference's scatter-add applies its updates; no atomics.
    aux is the Switch load-balance loss E * sum_e f_e p_e.

    With a mesh (expert parallelism), the routing runs on each device's
    batch shard, the router whole (`_moe_route`), and each device
    dispatches, runs and
    combines the experts it holds, E / model of them, for the tokens of
    its batch shard (`_moe_experts`); the partial outputs are summed over
    `model` by `cst`, where the reference's `cst` pins the combine.

    A `RoutedMoEConfig` routes and computes otherwise (`_moe_dropless`),
    has no mesh path, and computes its aux only with `train` (None
    otherwise: prefill and decode discard it).

    Recorded as the span `moe`, with the children `moe.route` and those of
    `_moe_experts` (`repro_torch.obs`)."""
    with obs.span("moe"):
        if isinstance(cfg.moe, RoutedMoEConfig):
            if mesh is not None:
                raise NotImplementedError(
                    "the dropless routed MoE (RoutedMoEConfig, the mla_moe "
                    "kind) has no device-mesh path: it runs on one device")
            return _moe_dropless(params, x, cfg.moe, train)
        return _moe_ffn(params, x, cfg, mesh)


def _moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig, mesh
             ) -> tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    E, K = m.num_experts, m.num_experts_per_tok
    C = moe_capacity(m, x.shape[1])

    # fp32 (the router is bf16 after a train step, as the reference casts
    # it, and its einsum promotes it back)
    x = cst(x, mesh, "B", None, None)

    def route(x, router):
        with obs.span("moe.route"):
            probs = torch.softmax(x.float() @ router.float(), dim=-1)
            return (probs, *_moe_route(probs, K))
    weights = (params.w_gate, params.w_up, params.w_down)
    if mesh is None:
        probs, chosen, topi = route(x, params.router)
        out = _moe_experts(x, chosen, topi, *weights, C=C, e0=0)
    else:
        from torch.distributed.tensor import Replicate, Shard
        batch = PT.batch_axes(mesh)
        ppl = _cst_placements(tuple(x.shape), mesh, ("B", None, None))
        rpl = (Replicate(),) * mesh.ndim        # the router whole
        probs, chosen, topi = _on_shards(
            route, mesh, (x, params.router), (ppl, rpl), (ppl, ppl, ppl),
            (ppl, _partial_on(rpl, mesh, batch)))
        r, n = _axis(mesh, "model")
        e_split = E % n == 0
        e_l = E // n if e_split else E
        wpl = tuple(Shard(0) if name == "model" and e_split else Replicate()
                    for name in mesh.mesh_dim_names)
        opl = _partial_on(ppl, mesh, ("model",) if e_split else ())
        gin = _partial_on(ppl, mesh, ("model",) if e_split else ())
        gw = _partial_on(wpl, mesh, batch)
        out = _on_shards(
            lambda x, c, t, wg, wu, wd: _moe_experts(
                x, c, t, wg, wu, wd, C=C, e0=r * e_l if e_split else 0),
            mesh, (x, chosen, topi, *weights), (ppl, ppl, ppl) + (wpl,) * 3,
            opl, (gin, gin, ppl) + (gw,) * 3)
        out = cst(out, mesh, "B", None, None)
    if m.num_shared_experts:
        out = out + params.shared(x, mesh)

    # Switch-style aux loss
    f = (chosen > 0).float().mean(dim=(0, 1)) / K
    aux = E * torch.sum(f * probs.mean(dim=(0, 1)))
    return out, aux


def _moe_route(probs: torch.Tensor, K: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (chosen (B, S, E): each token's renormalised top-K weights at
    their experts, 0 elsewhere; topi (B, S, K): those experts)."""
    topv, topi = top_k(probs, K)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return torch.zeros_like(probs).scatter(-1, topi, topv), topi


def _moe_experts(x: torch.Tensor, chosen: torch.Tensor, topi: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, *, C: int, e0: int) -> torch.Tensor:
    """The dispatch, expert FFNs and combine of experts e0 .. e0 + E_l - 1
    (E_l = w_gate.shape[0]; every expert when e0 = 0 and E_l = E): each
    token's output from those of its experts that kept it. Recorded as
    the spans `moe.dispatch` (with the slots, E_l x B x C, and those
    filled, `kept`), `moe.experts` and `moe.combine`."""
    B, S, D = x.shape
    E, E_l = chosen.shape[-1], w_gate.shape[0]
    with obs.span("moe.dispatch", slots=E_l * B * C) as span:
        if E_l != E:
            chosen = chosen[..., e0:e0 + E_l]
        # per (row, expert): the top C tokens by routing weight
        score = torch.where(chosen > 0, chosen, -1.0).transpose(1, 2)
        gate_c, idx_c = top_k(score, C)                          # (B, E, C)
        if span is not None:
            span.set(kept=(gate_c > 0).sum())
        rows = torch.arange(B, device=x.device)[:, None, None]
        xe = x[rows, idx_c]                                      # (B,E,C,D)
        xe = xe.transpose(0, 1).reshape(E_l, B * C, D)
    with obs.span("moe.experts"):
        gate = torch.bmm(xe, w_gate)
        up = torch.bmm(xe, w_up)
        act = F.silu(gate.float()).to(x.dtype) * up
        ye = torch.bmm(act, w_down)
    with obs.span("moe.combine"):
        w_c = torch.where(gate_c > 0, gate_c, 0.0)
        ye = ye.reshape(E_l, B, C, D).transpose(0, 1)
        ye = ye * w_c[..., None].to(ye.dtype)                    # (B,E,C,D)

        # token (b, s)'s slot in expert e, or -1, then its K experts' rows
        # in expert order
        slot = torch.full((B, E_l, S), -1, dtype=torch.long, device=x.device)
        slot.scatter_(2, idx_c,
                      torch.arange(C, device=x.device).expand(B, E_l, C))
        experts = topi.sort(dim=-1).values                       # (B, S, K)
        K = experts.shape[-1]
        if E_l != E:                    # this device's experts only
            local = experts - e0
            mine = (local >= 0) & (local < E_l)
            experts = local.clamp(0, E_l - 1)
        kslot = slot.transpose(1, 2).gather(2, experts)          # (B, S, K)
        if E_l != E:
            kslot = torch.where(mine, kslot, -1)
        flat = (experts * C + kslot.clamp_min(0)).reshape(B, S * K, 1)
        picked = ye.reshape(B, E_l * C, D).gather(
            1, flat.expand(B, S * K, D)).reshape(B, S, K, D)
        live = (kslot >= 0)[..., None]
        out = torch.zeros((B, S, D), dtype=ye.dtype, device=x.device)
        for j in range(K):
            out = out + torch.where(live[:, :, j], picked[:, :, j], 0.0)
        return out


def _moe_dropless(params: MoE, x: torch.Tensor, m: RoutedMoEConfig,
                  train: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The routed MoE of a `RoutedMoEConfig` (DeepSeek-V3, Kimi K2):
    x (B, S, D) -> (out, aux).

    Route (span `moe.route`, `_route_scores`): fp32 sigmoid scores s over
    all E experts, each token's K experts the top K of s + b (b the
    correction bias; ties in index order, `top_k`), their weights s_e /
    sum of the chosen s x `routed_scale`; b enters no weight. The
    route ends by counting the rows of each held expert and starting their
    copy to the host (`_to_host`). The shared expert (span `moe.shared`)
    is launched next, so that the device runs it while the host waits for
    the counts, the one wait for the device a layer. Then the held
    experts' part, dropless (`_held_experts`); the shared expert's output
    is added once, after the routed sum. aux, with `train` (else None), is
    the Switch load-balance loss E sum_e f_e p_e, f_e the share of
    choices that took expert e and p_e its mean score renormalised over
    the experts."""
    E, E_l = m.num_experts, params.w_gate.shape[0]
    with obs.span("moe.route"):
        scores, weights, topi = _route_scores(
            x, params.router, params.correction_bias, m)
        local = (topi - m.first_held).reshape(-1)
        key = torch.where((local >= 0) & (local < E_l), local, E_l)
        counts = torch.bincount(key, minlength=E_l + 1)[:E_l]
        sizes = _to_host(counts)
    shared = None
    if m.num_shared_experts:
        with obs.span("moe.shared"):
            shared = params.shared(x)
    out = _held_experts(x, weights, key, counts, sizes(), params.w_gate,
                        params.w_up, params.w_down)
    if shared is not None:
        out = out + shared
    if not train:
        return out, None
    f = torch.bincount(topi.reshape(-1), minlength=E).float() / topi.numel()
    p = (scores / scores.sum(-1, keepdim=True)).mean(dim=(0, 1))
    return out, E * torch.sum(f * p)


def _to_host(t: torch.Tensor):
    """-> a function that returns `t.tolist()`. On a CUDA device the copy
    starts now (into pinned memory, behind an event) and the function
    waits only for it, not for work launched after this call."""
    if not t.is_cuda:
        return t.tolist
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> list:
        done.synchronize()
        return host.tolist()
    return wait


def _route_scores(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
                  m: RoutedMoEConfig
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (scores (B, S, E) fp32, weights (B, S, K) fp32, topi (B, S, K)):
    see `_moe_dropless`."""
    scores = torch.sigmoid(x.float() @ router.float())
    _, topi = top_k(scores + bias.float(), m.num_experts_per_tok)
    w = scores.gather(-1, topi)
    return scores, w / w.sum(-1, keepdim=True) * m.routed_scale, topi


def _held_experts(x: torch.Tensor, weights: torch.Tensor, key: torch.Tensor,
                  counts: torch.Tensor, sizes: list, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The part of the routed output that the E_l held experts give
    (E_l = w_gate.shape[0]), for every (token, choice) routed to them: no
    capacity, nothing dropped. `key` (B x S x K,): each choice's held
    expert, E_l where it is not held; `counts` the rows of each held
    expert, `sizes` the same on the host.

    Dispatch (span `moe.dispatch`, attrs `held` E_l, `rows` the held
    (token, choice) pairs, `rows_max` those of the most loaded held
    expert): the choices stably sorted by held expert, so that each
    expert's rows stay in position order, and gathered, each buffer as
    long as its rows. Experts (span `moe.experts`, `_expert_ffn`): the
    three products per expert as grouped GEMMs. Combine (span
    `moe.combine`): each row times its weight (bf16), then added into its
    token's output expert by expert, in expert order, one bf16 add each
    (within an expert no token comes twice): deterministic, no atomics,
    as `_moe_experts` combines."""
    B, S, D = x.shape
    K, E_l = weights.shape[-1], w_gate.shape[0]
    with obs.span("moe.dispatch", held=E_l) as span:
        rows = sum(sizes)
        if span is not None:
            span.set(rows=rows, rows_max=max(sizes))
        if not rows:                    # (a decode step, often)
            return torch.zeros_like(x)
        pair = torch.sort(key, stable=True).indices[:rows]
        token = pair // K
        xs = x.reshape(B * S, D)[token]
    with obs.span("moe.experts"):
        ys = _expert_ffn(xs, w_gate, w_up, w_down, counts, sizes)
    with obs.span("moe.combine"):
        ys = ys * weights.reshape(-1)[pair, None].to(ys.dtype)
        out = torch.zeros((B * S, D), dtype=ys.dtype, device=x.device)
        a = 0
        for n in sizes:
            if n:
                t = token[a:a + n]
                out.index_copy_(0, t, out.index_select(0, t) + ys[a:a + n])
            a += n
        return out.reshape(B, S, D)


def _expert_ffn(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, counts: torch.Tensor, sizes: list
                ) -> torch.Tensor:
    """Each expert's SwiGLU over its rows of xs (rows grouped by expert,
    `sizes` of them each, `counts` the same on the device). On a CUDA
    device in bf16, three grouped GEMMs (`torch._grouped_mm`, the groups'
    ends on the device); elsewhere (the CPU, or fp32 weights) the plain
    version, one expert at a time."""
    if xs.is_cuda and xs.dtype == torch.bfloat16:
        offs = counts.cumsum(0).to(torch.int32)
        gate = torch._grouped_mm(xs, w_gate, offs=offs)
        up = torch._grouped_mm(xs, w_up, offs=offs)
        act = F.silu(gate.float()).to(xs.dtype) * up
        return torch._grouped_mm(act, w_down, offs=offs)
    return _expert_ffn_plain(xs, w_gate, w_up, w_down, sizes)


def _expert_ffn_plain(xs: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor, sizes: list
                      ) -> torch.Tensor:
    """`_expert_ffn`'s plain version: one expert's rows at a time."""
    out, a = [], 0
    for e, n in enumerate(sizes):
        xe = xs[a:a + n]
        act = F.silu((xe @ w_gate[e]).float()).to(xs.dtype) * (xe @ w_up[e])
        out.append(act @ w_down[e])
        a += n
    return torch.cat(out)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

class RG(nn.Module):
    """The Griffin recurrent block's weights: in-projections `w_x` and
    `w_gate` (d, dr), the causal conv of width 4 (`conv_w` (4, dr),
    `conv_b`), the RG-LRU gates `w_rg`, `w_ig` (dr, dr), the fp32 decay
    parameter `lam` (dr,) and `w_out` (dr, d). Built with a generator it
    is the reference's `init_rg`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        d = cfg.d_model
        dr = _rg_width(d)
        dev = gen.device if gen is not None else torch.device(device)

        def weight(*shape, scale):
            w = (_normal(gen, shape, scale) if gen is not None else
                 torch.empty(shape, dtype=torch.bfloat16, device=dev))
            return nn.Parameter(w, requires_grad=False)
        self.w_x = weight(d, dr, scale=d ** -0.5)
        self.w_gate = weight(d, dr, scale=d ** -0.5)
        self.conv_w = weight(4, dr, scale=0.5)
        self.conv_b = nn.Parameter(
            torch.zeros((dr,), dtype=torch.bfloat16, device=dev),
            requires_grad=False)
        self.w_rg = weight(dr, dr, scale=dr ** -0.5)
        self.w_ig = weight(dr, dr, scale=dr ** -0.5)
        # softplus^-1 of 3..8, so a = sigmoid-gated decay starts near
        # 0.9..0.999
        lam = torch.log(torch.expm1(torch.linspace(3.0, 8.0, dr)))
        self.lam = nn.Parameter(lam.to(dev), requires_grad=False)
        self.w_out = weight(dr, d, scale=dr ** -0.5)


def _rg_ab(params: RG, u: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay a_t and input term b_t in fp32. u: (..., dr)."""
    return _rg_gates(u, u, params.w_rg, params.w_ig, params.lam)


def _rg_gates(u_all: torch.Tensor, u: torch.Tensor, w_rg: torch.Tensor,
              w_ig: torch.Tensor, lam: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """`_rg_ab` on columns: the gates' products take every channel of
    `u_all`, and give the columns of `w_rg`, `w_ig` and `lam`, which are
    those of `u` (the whole width, u_all being u, or one device's
    shard)."""
    uf = u_all.float()
    r = torch.sigmoid(uf @ w_rg.float())
    i = torch.sigmoid(uf @ w_ig.float())
    if u is not u_all:
        uf = u.float()
    log_a = -8.0 * r * F.softplus(lam)                       # c = 8
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, for all t at
    once: returns (prod a_0..a_t, h_t). The log-depth odd/even recursion
    of `jax.lax.associative_scan` (which the reference calls), step for
    step, so the sums run in its order: about 3 log2(S) tensor ops instead
    of S sequential steps."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def combine(a1, b1, a2, b2):
        return a1 * a2, a2 * b1 + b2

    # adjacent pairs (0, 1), (2, 3), ... reduced, then scanned
    odd_a, odd_b = linear_scan(*combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                        a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        even_a, even_b = combine(odd_a[:, :-1], odd_b[:, :-1],
                                 a[:, 2::2], b[:, 2::2])
    else:
        even_a, even_b = combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even may be one longer)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1],
                          *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def rg_block(params: RG, x: torch.Tensor, mode: str,
             cache: dict | None, mesh=None
             ) -> tuple[torch.Tensor, dict | None]:
    """Griffin recurrent block: in-projections -> causal conv4 -> RG-LRU ->
    gelu gate -> out-projection. x: (B, S, D). Returns (out, new_cache).
    In decode mode (S = 1) the recurrence state (fp32) and the conv's last
    three inputs are written into `cache` in place, and the same tensors
    come back as the new cache; the step computes what a prefill computes
    at its last position, conv rounding included. With a mesh the scan
    runs on each device's shard of the recurrence width (`model`)."""
    B, S, _ = x.shape
    u = cst(x @ params.w_x, mesh, "B", None, "model")
    g = cst(x @ params.w_gate, mesh, "B", None, "model")
    if mode == "decode":
        window = torch.cat([cache["conv"], u], dim=1)       # (B, 4, dr)
        # the prefill's arithmetic below, for its last position: four
        # bf16 products added in order. (The reference's decode contracts
        # the window in one einsum and rounds once, so its decode and
        # prefill disagree on the conv by a bf16 rounding, which 26 rg
        # layers grow to 0.057 of max |logit| at recurrentgemma-9b's full
        # width.)
        cu = sum(params.conv_w[j] * window[:, j] for j in range(4)) \
            + params.conv_b
        a, b = _rg_ab(params, cu)
        h = a * cache["state"] + b                          # (B, dr)
        cache["state"].copy_(h)
        cache["conv"].copy_(window[:, 1:])
        new_cache = cache
        h = h[:, None]
    else:
        # causal conv of width 4 as shifted adds, in bf16 as the reference
        cu = (_rg_conv(u, params.conv_w, params.conv_b) if mesh is None
              else _rg_conv_on_shards(params, u, mesh))
        if mesh is None:
            a, b = _rg_ab(params, cu)                       # (B, S, dr)
            _, h = linear_scan(a, b)
        else:
            h = _rg_scan_on_shards(params, cu, mesh)
        new_cache = ({"state": h[:, -1], "conv": u[:, -3:]}
                     if mode == "prefill" else None)
    gate = F.gelu(g.float(), approximate="tanh").to(x.dtype)
    out = h.to(x.dtype) * gate
    return _row_parallel(out, params.w_out, mesh), new_cache


def _rg_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """The causal conv of width 4 over u (B, S, dr) as shifted adds."""
    S = u.shape[1]
    return sum(w[j] * F.pad(u, (0, 0, 3 - j, 0))[:, :S]
               for j in range(4)) + b


def _rg_conv_on_shards(params: RG, u: torch.Tensor, mesh) -> torch.Tensor:
    """`_rg_conv` on each device's channels (u split as `cst` pins it)."""
    from torch.distributed.tensor import Replicate, Shard
    upl = tuple(u.placements)
    split = Shard(2) in upl
    wpl = tuple(Shard(1) if n == "model" and split else Replicate()
                for n in mesh.mesh_dim_names)
    bpl = tuple(Shard(0) if n == "model" and split else Replicate()
                for n in mesh.mesh_dim_names)
    batch = PT.batch_axes(mesh)
    return _on_shards(_rg_conv, mesh, (u, params.conv_w, params.conv_b),
                      (upl, wpl, bpl), upl,
                      (upl, _partial_on(wpl, mesh, batch),
                       _partial_on(bpl, mesh, batch)))


def _rg_scan_on_shards(params: RG, cu: torch.Tensor, mesh) -> torch.Tensor:
    """The RG-LRU gates and scan in train / prefill mode on each device's
    channels (the recurrence width over `model`, column-parallel gates:
    every channel of the conv output in, this device's columns of w_rg,
    w_ig and lam): h (B, S, dr) split as cu is."""
    from torch.distributed.tensor import Replicate, Shard
    cpl = _cst_placements(tuple(cu.shape), mesh, ("B", None, "model"))
    allpl = _cst_placements(tuple(cu.shape), mesh, ("B", None, None))
    split = Shard(2) in cpl
    wpl = tuple(Shard(1) if n == "model" and split else Replicate()
                for n in mesh.mesh_dim_names)
    lpl = tuple(Shard(0) if n == "model" and split else Replicate()
                for n in mesh.mesh_dim_names)
    batch = PT.batch_axes(mesh)

    def scan(u_all, u, w_rg, w_ig, lam):
        a, b = _rg_gates(u_all, u, w_rg, w_ig, lam)
        return linear_scan(a, b)[1]
    if _axis(mesh, "model")[1] == 1:        # every channel is here
        return _on_shards(
            lambda u, *w: scan(u, u, *w), mesh,
            (cu, params.w_rg, params.w_ig, params.lam), (cpl, wpl, wpl, lpl),
            cpl, (cpl,) + tuple(_partial_on(p, mesh, batch)
                                for p in (wpl, wpl, lpl)))
    return _on_shards(
        scan, mesh, (cu, cu, params.w_rg, params.w_ig, params.lam),
        (allpl, cpl, wpl, wpl, lpl), cpl,
        (_partial_on(allpl, mesh, ("model",) if split else ()), cpl,
         _partial_on(wpl, mesh, batch), _partial_on(wpl, mesh, batch),
         _partial_on(lpl, mesh, batch)))


# ---------------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay, and channel-mix
# ---------------------------------------------------------------------------

class RWKV(nn.Module):
    """The RWKV6 time-mix weights: the token-shift mixes `mu` (5, d) for
    r, k, v, w, g; the projections `w_r`, `w_k`, `w_v`, `w_g`, `w_o` and
    the decay projection `w_decay` (d, d); the fp32 `decay_base` and
    `bonus` (d,); the output norm `ln_x` (an RMSNorm over all of d). Built
    with a generator it is the reference's `init_rwkv`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        d = cfg.d_model
        dev = gen.device if gen is not None else torch.device(device)
        s = d ** -0.5

        def weight(*shape, scale):
            w = (_normal(gen, shape, scale) if gen is not None else
                 torch.empty(shape, dtype=torch.bfloat16, device=dev))
            return nn.Parameter(w, requires_grad=False)
        mu = (torch.rand((5, d), generator=gen, device=dev).bfloat16()
              if gen is not None else
              torch.empty((5, d), dtype=torch.bfloat16, device=dev))
        self.mu = nn.Parameter(mu, requires_grad=False)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, weight(d, d, scale=s))
        self.w_decay = weight(d, d, scale=s * 0.1)
        self.decay_base = nn.Parameter(
            torch.linspace(-6.0, -0.1, d, device=dev), requires_grad=False)
        bonus = (torch.randn((d,), generator=gen, device=dev) * 0.1
                 if gen is not None else
                 torch.empty((d,), dtype=torch.float32, device=dev))
        self.bonus = nn.Parameter(bonus, requires_grad=False)
        self.ln_x = nn.Parameter(torch.ones((d,), dtype=torch.bfloat16,
                                            device=dev), requires_grad=False)


def rwkv_chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w_log: torch.Tensor, u: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV, the reference's `_rwkv_chunk_scan` step for step, in
    fp32. r, k, v, w_log: (B, S, H, hd), w_log the log decay (<= 0); u:
    (H, hd) the bonus; S a multiple of `chunk`. Returns y (B, S, H, hd)
    and the final state (B, H, hd, hd).

    Within a chunk, from inclusive cumulative log decays W: y_i = r_i
    W_{i-1} (sum_{j<i} k_j / W_j v_j) + (r_i . u k_i) v_i; across chunks
    a Python loop carries the state S <- diag(W_c) S + sum_j diag(W_c /
    W_j) k_j v_j. Every exponent is clamped at -60, as the reference
    clamps it. The einsums must run in full fp32: on the card, TF32
    matmuls (`torch.backends.cuda.matmul.allow_tf32`) have to be off."""
    B, S, H, hd = r.shape
    nc = S // chunk
    rc, kc, vc, wc = (t.reshape(B, nc, chunk, H, hd).float()
                      for t in (r, k, v, w_log))
    cum = torch.cumsum(wc, dim=2)                       # W_i (inclusive)
    w_total = cum[:, :, -1]                             # (B, nc, H, hd)
    q_fac = torch.exp(torch.clamp_min(cum - wc, -60.0))   # exclusive
    k_fac = torch.exp(torch.clamp_min(-cum, -60.0))       # 1 / W_j
    att = torch.einsum("bnihd,bnjhd->bnhij", rc * q_fac, kc * k_fac)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    att = torch.where(tri, att, 0.0)                    # strictly lower
    y = torch.einsum("bnhij,bnjhd->bnihd", att, vc)
    diag = torch.einsum("bnihd,bnihd->bnih", rc, kc * u)
    y = y + diag[..., None] * vc                        # bonus diagonal

    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    cross = []
    for n in range(nc):
        cum_n, w_n, wtot = cum[:, n], wc[:, n], w_total[:, n]
        r_dec = rc[:, n] * torch.exp(torch.clamp_min(cum_n - w_n, -60.0))
        cross.append(torch.einsum("bihk,bhkv->bihv", r_dec, state))
        decay_j = torch.exp(torch.clamp_min(wtot[:, None] - cum_n, -60.0))
        kv = torch.einsum("bjhk,bjhv->bhkv", kc[:, n] * decay_j, vc[:, n])
        state = torch.exp(wtot)[..., None] * state + kv
    y = y + torch.stack(cross, dim=1)
    return y.reshape(B, S, H, hd), state


def rwkv_chunk(S: int) -> int:
    """The scan's chunk for a sequence of S, the reference's choice: 32,
    or S below 32, or else the largest divisor of S up to 32 (23 at S =
    2047)."""
    return 32 if S % 32 == 0 else (S if S < 32 else _chunk(S, 32))


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every t of x (B, S, D), zero before the first token."""
    return F.pad(x, (0, 0, 1, 0))[:, :x.shape[1]]


def rwkv_block(params: RWKV, x: torch.Tensor, cfg: ModelConfig, mode: str,
               cache: dict | None, mesh=None
               ) -> tuple[torch.Tensor, dict | None]:
    """RWKV6 time-mix. x: (B, S, D). Returns (out, new_cache), the cache
    {"state": (B, H, hd, hd) fp32, "shift": (B, D)} O(1) in the sequence
    length. Train and prefill run `rwkv_chunk_scan` at `rwkv_chunk(S)`. In
    decode mode (S = 1) the exact one-step recurrence runs, and the new
    state and shift are written into `cache` in place (the same tensors
    come back as the new cache). With a mesh the projections are pinned
    (B, S, D over `model`), as the reference pins them, and the scan (or
    the step) runs on each device's batch rows and whole heads."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    x_prev = (cache["shift"][:, None] if mode == "decode"
              else _along_seq(_shifted, mesh, x))
    mu = params.mu

    def mix(i):
        return x * mu[i] + x_prev * (1 - mu[i])
    r, k, v, g = (cst(mix(i) @ w, mesh, "B", None, "model") for i, w in
                  ((0, params.w_r), (1, params.w_k), (2, params.w_v),
                   (4, params.w_g)))
    # data-dependent log decay (<= 0): -exp(base + proj)
    w_log = -torch.exp(params.decay_base + (mix(3) @ params.w_decay).float())

    def heads(*ts):             # (b, s, d) -> (b, s, d // hd, hd)
        return tuple(t.reshape(*t.shape[:2], -1, hd) for t in ts)

    def step(r, k, v, w_log, u, state):
        return _rwkv_step(*heads(r, k, v, w_log), u.reshape(-1, hd),
                          state).reshape(r.shape)

    def scan(r, k, v, w_log, u):
        y, state = rwkv_chunk_scan(*heads(r, k, v, w_log),
                                   u.reshape(-1, hd), rwkv_chunk(S))
        return y.reshape(r.shape), state

    def shards(fn, args, *pl):
        return fn(*args) if mesh is None else _on_shards(fn, mesh, args, *pl)
    xpl = upl = spl = cpl = gpl = None
    if mesh is not None:
        n = PT.axis_sizes(mesh).get("model", 1)
        split = "model" if D % n == 0 and (D // n) % hd == 0 else None
        xpl = _cst_placements((B, S, D), mesh, ("B", None, split))
        upl = _cst_placements((D,), mesh, (split,))
        spl = _cst_placements((B, D // hd, hd, hd), mesh, ("B", split))
        if mode == "decode":
            cpl = tuple(cache["state"].placements)
        # every rank of a batch axis reads the bonus whole
        gpl = (xpl,) * 4 + (_partial_on(upl, mesh, PT.batch_axes(mesh)),)

    if mode == "decode":
        y = shards(step, (r, k, v, w_log, params.bonus, cache["state"]),
                   (xpl,) * 4 + (upl, cpl), xpl)
        cache["shift"].copy_(x[:, -1])
        new_cache = cache
    else:
        y, state = shards(scan, (r, k, v, w_log, params.bonus),
                          (xpl,) * 4 + (upl,), (xpl, spl), gpl)
        new_cache = ({"state": state, "shift": x[:, -1]}
                     if mode == "prefill" else None)
    y = rms_norm(y.to(x.dtype), params.ln_x, cfg.rms_eps)
    y = y * F.silu(g.float()).to(x.dtype)
    return _row_parallel(y, params.w_o, mesh), new_cache


def _rwkv_step(r, k, v, w_log, u, state) -> torch.Tensor:
    """The exact one-step WKV recurrence: r, k, v, w_log (B, 1, H, hd),
    u (H, hd); `state` (B, H, hd, hd) fp32 is advanced in place. Returns
    y (B, H, hd) fp32."""
    r1, k1, v1 = (t[:, 0].float() for t in (r, k, v))
    y = torch.einsum("bhk,bhkv->bhv", r1, state) + \
        (r1 * (u * k1)).sum(-1, keepdim=True) * v1
    new_state = torch.exp(w_log[:, 0])[..., None] * state + \
        torch.einsum("bhk,bhv->bhkv", k1, v1)
    state.copy_(new_state)
    return y


class RWKVChannel(nn.Module):
    """The RWKV channel-mix weights: the token-shift mix `mu_c` (d,), `w_kc`
    (d, f) and `w_vc` (f, d). Built with a generator it is the reference's
    `init_rwkv_channel`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dev = gen.device if gen is not None else torch.device(device)
        mu = (torch.rand((d,), generator=gen, device=dev).bfloat16()
              if gen is not None else
              torch.empty((d,), dtype=torch.bfloat16, device=dev))
        self.mu_c = nn.Parameter(mu, requires_grad=False)
        for name, shape in (("w_kc", (d, f)), ("w_vc", (f, d))):
            w = (_normal(gen, shape, shape[0] ** -0.5) if gen is not None
                 else torch.empty(shape, dtype=torch.bfloat16, device=dev))
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def rwkv_channel_mix(params: RWKVChannel, x: torch.Tensor, mode: str,
                     cache: dict | None, mesh=None
                     ) -> tuple[torch.Tensor, dict | None]:
    """relu(lerp(x, x_prev) W_k)^2 W_v. Returns (out, new_cache), the cache
    {"shift_c": (B, D)}; in decode mode the shift is written into `cache`
    in place."""
    x_prev = (cache["shift_c"][:, None] if mode == "decode"
              else _along_seq(_shifted, mesh, x))
    h = x * params.mu_c + x_prev * (1 - params.mu_c)
    kk = cst(h @ params.w_kc, mesh, "B", None, "model")
    act = torch.relu(kk.float()).square().to(x.dtype)
    out = _row_parallel(act, params.w_vc, mesh)
    if mode == "decode":
        cache["shift_c"].copy_(x[:, -1])
        return out, cache
    return out, ({"shift_c": x[:, -1]} if mode == "prefill" else None)


# ---------------------------------------------------------------------------
# Cross-attention (vision, Llama 3.2 Vision style, gated)
# ---------------------------------------------------------------------------

class CrossAttention(Attention):
    """`Attention`'s weights (ghost heads included) and the fp32 0-d gates
    `gate_attn` and `gate_ffn`, zero at init: the reference's
    `init_cross_attention`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__(cfg, gen, device)
        dev = self.wq.device
        self.gate_attn = nn.Parameter(torch.zeros((), device=dev),
                                      requires_grad=False)
        self.gate_ffn = nn.Parameter(torch.zeros((), device=dev),
                                     requires_grad=False)


def cross_attention_block(params: CrossAttention, x: torch.Tensor,
                          cfg: ModelConfig, mode: str, cache: dict | None,
                          vision: torch.Tensor | None, mesh=None
                          ) -> tuple[torch.Tensor, dict | None]:
    """Queries from the text stream, keys and values from the stub vision
    embeddings `vision` (B, Sv, D); no rope, no bias. Train and prefill
    project k, v from `vision` (prefill returns them as the cache
    {"k", "v"}: (B, Hkv, Sv, hd)); decode reads them from `cache` and
    returns it unchanged. Attention is `flash_attention(..., causal=False)`
    in every mode, decode (Sq = 1) included. Returns (tanh(gate_attn) x
    out, new_cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads_padded, cfg.num_kv_heads_padded
    q = _whole_heads(cst(x @ params.wq, mesh, "B", None, "model"), mesh,
                     hq).reshape(B, S, hq, hd).transpose(1, 2)
    if mode == "decode" and cache is not None and "k" in cache:
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        if vision is None:
            raise ValueError(f"{cfg.name}: cross-attention needs `vision` "
                             f"(B, {cfg.vision_seq}, {cfg.d_model}) in "
                             f"{mode} mode")
        vision = vision.to(params.wk.dtype)     # fp32 weights: promoted
        k, v = (_whole_heads(cst(vision @ w, mesh, "B", None, "model"), mesh,
                             hkv).reshape(B, -1, hkv, hd).transpose(1, 2)
                for w in (params.wk, params.wv))
        new_cache = {"k": k, "v": v} if mode != "train" else None
    q, k, v = _shard_attn_heads(mesh, q, k, v)
    out = flash_attention(q, k, v, causal=False, mesh=mesh)
    out = cst(out.transpose(1, 2).reshape(B, S, hq * hd), mesh, "B", None,
              "model")
    out = _row_parallel(out, params.wo, mesh)
    return torch.tanh(params.gate_attn).to(x.dtype) * out, new_cache
