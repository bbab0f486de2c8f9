"""Flash-attention forward: online softmax over key tiles, GQA, causal and
sliding-window masks, fully masked tiles skipped.

Port of the Pallas kernel `repro.kernels.flash_attention.flash_attention_fwd`
as two hand-written CUDA kernels, routed by dtype:

- bf16: `flash_fwd_sm90_kernel` (`csrc/flash_fwd_sm90.cu`), built for
  Hopper at (dk, dv) in {(64, 64), (128, 128), (256, 256)}: a persistent
  grid whose CTAs walk 128-row q tiles over key tiles (128 keys, or 64 at
  head dim 256), one producer warpgroup feeding a TMA ring and two
  consumer warpgroups taking turns on `wgmma`;
- fp32: `flash_fwd_kernel` (`csrc/flash_attention.cu`), scalar FMA, 64 x 64
  tiles (wgmma has no full-fp32 product), at (64, 64) and (128, 128) only:
  its tiles do not fit at 256 (ROADMAP B6).

Both take any Sq, Skv >= 1 (the Pallas kernel needs them to divide its
blocks), so the port's CUDA path has no branch to a plain version.

`flash_attention_fwd` is the wrapper: a CUDA tensor launches one of the
kernels (and counts it in `launches`, an fp32 one also in
`fp32_launches`), a CPU tensor takes
`flash_attention_fwd_plain` (counted in `plain_calls`). There is no
fallback from one to the other. `block_q` / `block_k` shape only the plain
version's block loop; the kernels' tiles are fixed by their design.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30
#: (dk, dv) pairs the bf16 CUDA kernel is built for.
HEAD_DIMS = ((64, 64), (128, 128), (256, 256))
#: (dk, dv) pairs the fp32 CUDA kernel is built for.
FP32_HEAD_DIMS = ((64, 64), (128, 128))
#: C entry point of the kernel for each input dtype.
_ENTRY = {torch.float32: "repro_flash_fwd_f32",
          torch.bfloat16: "repro_flash_fwd_bf16"}

launches = 0        # CUDA kernel launches, both kernels
fp32_launches = 0   # of those, launches of the fp32 `flash_fwd_kernel`
plain_calls = 0     # plain-PyTorch evaluations (CPU tensors)
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global launches, fp32_launches, plain_calls
    with _COUNT_LOCK:
        launches = fp32_launches = plain_calls = 0


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = DEFAULT_BLOCK_K
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's block loop step by step, in plain PyTorch:
    fp32 scores and p, running max / sum / accumulator per query block,
    key blocks outside the causal triangle or the window skipped. A ragged
    last block is a shorter slice."""
    B, Hq, Sq, dk = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    scale = dk ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Hkv, G, Sq, dk)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, G, Sq, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    for q_start in range(0, Sq, bq):
        qb = qf[:, :, :, q_start:q_start + bq]
        n = qb.shape[3]
        m = torch.full((B, Hkv, G, n), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, n, dv), dtype=torch.float32,
                          device=dev)
        for k_start in range(0, Skv, bk):
            live = True
            if causal:
                live = k_start <= q_start + bq - 1
            if window:
                live = live and k_start + bk - 1 > q_start - window
            if not live:
                continue
            kb = kf[:, :, k_start:k_start + bk]
            vb = vf[:, :, k_start:k_start + bk]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            if causal or window:
                qpos = q_start + torch.arange(n, device=dev)[:, None]
                kpos = k_start + torch.arange(kb.shape[2], device=dev)[None]
                mask = torch.ones((n, kb.shape[2]), dtype=torch.bool,
                                  device=dev)
                if causal:
                    mask &= qpos >= kpos
                if window:
                    mask &= qpos - kpos < window
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG_INF / 2, 0.0, p)
            corr = torch.exp(m - m_new)
            corr = torch.where(m <= NEG_INF / 2, 0.0, corr)
            l = l * corr + p.sum(dim=-1)
            m = m_new
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb)
        out[:, :, :, q_start:q_start + n] = (
            acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        lse[:, :, :, q_start:q_start + n] = torch.where(
            l > 0, m + torch.log(l.clamp_min(1e-30)), -torch.inf)
    return out.reshape(B, Hq, Sq, dv), lse.reshape(B, Hq, Sq)


def unmasked_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the masks keep."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i, max=Skv - 1) if causal else torch.full_like(i, Skv - 1)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int((hi - lo + 1).clamp_min(0).sum())


def bound_flops(B: int, Hq: int, Sq: int, Skv: int, dk: int, dv: int, *,
                causal: bool = True, window: int = 0) -> int:
    """Operations the two products need over the unmasked pairs:
    2 * dk for the score and 2 * dv for its share of the output."""
    return B * Hq * unmasked_pairs(Sq, Skv, causal, window) * 2 * (dk + dv)


def bound_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, dk: int,
                dv: int, itemsize: int) -> int:
    """Bytes the forward must move: q, k, v read once, out and the fp32
    lse written once."""
    return (itemsize * (B * Hq * Sq * (dk + dv) + B * Hkv * Skv * (dk + dv))
            + 4 * B * Hq * Sq)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes q (B, Hq, Sq, dk), "
                         "k (B, Hkv, Skv, dk), v (B, Hkv, Skv, dv)")
    B, Hq, Sq, dk = q.shape
    if (k.shape[0] != B or k.shape[3] != dk or v.shape[:3] != k.shape[:3]
            or Hq % k.shape[1] or min(Sq, k.shape[2]) < 1):
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention_fwd: q, k, v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if window < 0:
        raise ValueError(f"flash_attention_fwd: window {window} < 0")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, Sq, dk), k (B, Hkv, Skv, dk), v (B, Hkv, Skv, dv) ->
    (out (B, Hq, Sq, dv) in q's dtype, lse (B, Hq, Sq) fp32), one launch."""
    global launches, fp32_launches, plain_calls
    _check(q, k, v, window)
    if q.device.type == "cpu":
        with _COUNT_LOCK:
            plain_calls += 1
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, block_q=block_q,
                                         block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, "
                         f"got {q.device}")
    B, Hq, Sq, dk = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention_fwd takes bf16 or fp32 on CUDA, "
                        f"got {q.dtype}")
    if (dk, dv) not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_fwd: no CUDA kernel for head dims dk={dk}, "
            f"dv={dv} (built for {HEAD_DIMS}); the model layer routes head "
            f"dims that are not multiples of 128 blockwise (ROADMAP C1)")
    if q.dtype == torch.float32 and (dk, dv) not in FP32_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_fwd: no fp32 CUDA kernel for head dims "
            f"dk={dk}, dv={dv} (built for {FP32_HEAD_DIMS}); the fp32 "
            f"forward at 256 is ROADMAP B6")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd needs a contiguous, "
                             f"16-byte aligned {name}")
    if q.dtype == torch.float32 and B * Hq > 65535:
        raise ValueError(f"flash_attention_fwd: B * Hq = {B * Hq} > 65535")
    out = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    entry = getattr(_build.library(), _ENTRY[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), B, Hq, Hkv, Sq, Skv, dk,
                    int(bool(causal)), int(window),
                    ctypes.c_float(dk ** -0.5), stream)
    _build.check(err, _ENTRY[q.dtype])
    with _COUNT_LOCK:
        launches += 1
        if q.dtype == torch.float32:
            fp32_launches += 1
    return out, lse
