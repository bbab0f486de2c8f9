"""Flash-attention forward: online softmax over key tiles, GQA, causal and
sliding-window masks, fully masked tiles skipped.

Port of the Pallas kernel `repro.kernels.flash_attention.flash_attention_fwd`
as three hand-written CUDA kernels for Hopper, routed by dtype and by the
rows a kv head serves (G x Sq, G = Hq / Hkv), all at (dk, dv) in
{(64, 64), (128, 128), (256, 256)}:

- bf16, G x Sq <= `DECODE_ROWS` (a decode step: the vision model's
  cross-attention at Sq = 1): `flash_decode_sm90_kernel`
  (`csrc/flash_decode_sm90.cu`), split-KV: (B x Hkv) x n_split CTAs,
  each over one slice of one kv head's keys with the G x Sq rows that
  read it packed into one 16-row tile, so K and V are read once; then
  `flash_decode_combine_kernel` merges the slices' (acc, m, l).
  `flash_decode_plain` is its algorithm step by step;
- bf16, more rows: `flash_fwd_sm90_kernel` (`csrc/flash_fwd_sm90.cu`): a
  persistent grid whose CTAs walk 128-row q tiles over key tiles (128
  keys, or 64 at head dim 256), one producer warpgroup feeding a TMA
  ring and two consumer warpgroups taking turns on `wgmma`;
- fp32: `flash_fwd_f32_sm90_kernel` (`csrc/flash_fwd_f32_sm90.cu`): the
  tensor cores in TF32 with each operand split into a TF32 high and low
  part (three `mma.sync` m16n8k8 products: hi*hi + hi*lo + lo*hi), which
  holds fp32 accuracy; 64-row q tiles of 4 warps over 32-key tiles in a
  2-stage `cp.async` ring, S, P and O in registers.

All take any Sq, Skv >= 1 (the Pallas kernel needs them to divide its
blocks), so the port's CUDA path has no branch to a plain version.

`flash_attention_fwd` is the wrapper. The route is the same on both
devices: a bf16 call with G x Sq <= `DECODE_ROWS` takes the decode path,
every other call the prefill path. A CUDA tensor launches the route's
kernel (counted in `launches`, each also in `mode_launches` under
(causal, Sq == 1), a decode launch also in `decode_launches`, an fp32 one
in `fp32_launches`); a CPU tensor takes `flash_decode_plain` or
`flash_attention_fwd_plain` (counted in `plain_calls`). There is no
fallback from one to the other. `block_q` / `block_k` shape only the
prefill plain version's block loop; the kernels' tiles are fixed by their
design.

Head dims no kernel takes (hubert's 80, kimi-k2's 112, MLA's 288 / 256)
attend blockwise, the reference's jnp route: `flash_attention_blockwise`
runs `flash_attention_fwd_plain` on real tensors and, on fake tensors
(the dry-run's), the operator `torch.ops.repro_torch.
flash_attention_blockwise_fwd`, so a 32K-token layer traces as one op with
the loop's FLOPs (`blockwise_flops`) instead of thousands of block ops.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .autotune import H100_SMS, device_sms

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30
#: (dk, dv) pairs the CUDA kernels are built for, in bf16 and fp32.
HEAD_DIMS = ((64, 64), (128, 128), (256, 256))
#: C entry point of the kernel for each input dtype.
_ENTRY = {torch.float32: "repro_flash_fwd_f32",
          torch.bfloat16: "repro_flash_fwd_bf16"}
_DECODE_ENTRY = "repro_flash_decode_bf16"
#: bf16 calls with G x Sq at most this many rows take the decode path
#: (`kRows` in csrc/flash_decode_sm90.cu: one 16-row `mma.sync` tile)
DECODE_ROWS = 16
#: the decode kernel's key tile (`kBK`): slices are whole tiles
DECODE_BK = 64

launches = 0        # CUDA kernel launches, all kernels
fp32_launches = 0   # of those, launches of `flash_fwd_f32_sm90_kernel`
decode_launches = 0  # of those, launches of `flash_decode_sm90_kernel`
plain_calls = 0     # plain-PyTorch evaluations (CPU tensors)
#: launches by (causal, Sq == 1): a model's prefills launch Sq > 1, its
#: decode steps (cross-attention only) Sq == 1
mode_launches: dict[tuple[bool, bool], int] = {}
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global launches, fp32_launches, decode_launches, plain_calls
    with _COUNT_LOCK:
        launches = fp32_launches = decode_launches = plain_calls = 0
        mode_launches.clear()


def is_decode(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The wrapper's route: bf16 with G x Sq <= `DECODE_ROWS` rows a kv
    head goes to the decode path, on either device."""
    return (q.dtype == torch.bfloat16
            and q.shape[1] // k.shape[1] * q.shape[2] <= DECODE_ROWS)


def decode_splits(bh: int, skv: int, sms: int) -> int:
    """Key slices per (batch x kv head) for the decode kernel: enough that
    `bh` x slices CTAs put one on each of `sms` SMs in one wave, each
    slice a whole number of `DECODE_BK`-key tiles and none empty. Two
    CTAs fit an SM at d = 128, but one an SM ran faster at the vision
    decode on an H100 (4 slices against 8: PERF.md §6). At the vision
    decode (bh 32, Skv 6404, 132 SMs): 4 slices of 26 tiles, the last of
    1,412 keys."""
    n_tiles = -(-skv // DECODE_BK)
    want = max(1, min(n_tiles, sms // bh))
    per = -(-n_tiles // want)
    return -(-n_tiles // per)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, n_split: int = 1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's split-KV algorithm step by step, in plain
    PyTorch: the keys cut into `n_split` slices of whole `DECODE_BK`-key
    tiles (the last ends at Skv; slices past it are empty), per slice the
    Pallas kernel's rules in fp32 (masked scores give p = 0, m starts at
    -1e30, so a slice no row sees has m = -1e30, l = 0), then the combine:
    M = max_j m_j, l = sum_j l_j e^(m_j - M), out = sum_j acc_j
    e^(m_j - M) / max(l, 1e-30) in q's dtype, lse = M + log(l) where
    l > 0, else -inf."""
    B, Hq, Sq, dk = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = dk ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Hkv, G, Sq, dk)
    kf, vf = k.float(), v.float()
    n_tiles = -(-Skv // DECODE_BK)
    per = -(-n_tiles // n_split) * DECODE_BK             # keys a slice
    ms, ls, accs = [], [], []
    for j in range(n_split):
        lo, hi = j * per, min((j + 1) * per, Skv)
        m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, Sq, dv), dtype=torch.float32,
                          device=dev)
        if lo < hi:
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, lo:hi]) * scale
            qpos = torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(lo, hi, device=dev)[None]
            mask = torch.ones((Sq, hi - lo), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos >= kpos
            if window:
                mask &= qpos - kpos < window
            s = torch.where(mask, s, NEG_INF)
            m = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(s <= NEG_INF / 2, 0.0,
                            torch.exp(s - m[..., None]))
            l = p.sum(dim=-1)
            acc = torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, lo:hi])
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    M = m.amax(dim=0)
    w = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - M))
    l = (l * w).sum(dim=0)
    acc = (acc * w[..., None]).sum(dim=0)
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    lse = torch.where(l > 0, M + torch.log(l.clamp_min(1e-30)), -torch.inf)
    return out.reshape(B, Hq, Sq, dv), lse.reshape(B, Hq, Sq)


def _live_block(q_start: int, k_start: int, bq: int, bk: int,
                causal: bool, window: int) -> bool:
    """Whether the block loop visits the key block at `k_start` for the
    query block at `q_start`: the Pallas kernel's causal and window
    skips."""
    live = True
    if causal:
        live = k_start <= q_start + bq - 1
    if window:
        live = live and k_start + bk - 1 > q_start - window
    return live


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
            if not _live_block(q_start, k_start, bq, bk, causal, window):
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
    i = np.arange(Sq, dtype=np.int64)    # numpy: no dispatch mode sees it
    hi = np.minimum(i, Skv - 1) if causal else np.full_like(i, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


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


def blockwise_flops(B: int, Hq: int, Sq: int, Skv: int, dk: int, dv: int,
                    *, causal: bool = True, window: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> int:
    """What `flash_attention_fwd_plain`'s two einsums count: 2 * B * Hq *
    n_q * n_k * (dk + dv) summed over the blocks its causal and window
    tests keep, masked pairs inside a kept block included."""
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    pairs = sum(min(bq, Sq - q0) * min(bk, Skv - k0)
                for q0 in range(0, Sq, bq) for k0 in range(0, Skv, bk)
                if _live_block(q0, k0, bq, bk, causal, window))
    return 2 * B * Hq * pairs * (dk + dv)


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
    (out (B, Hq, Sq, dv) in q's dtype, lse (B, Hq, Sq) fp32): one launch
    of the dtype's prefill kernel, or on the decode route (`is_decode`)
    one of the decode kernel and one of its combine: the CUDA
    implementation of the operator `torch.ops.repro_torch.
    flash_attention_fwd`, called directly (the dispatcher's boxed call
    into a Python kernel cost 17-35 us a call beside an H100, PERF.md
    §6). A fake tensor (the dry-run's) takes the operator, on
    any device: its fake implementation gives the shapes of the card's
    route, its FLOP formula the kernel's operations."""
    global plain_calls
    _check(q, k, v, window)
    if isinstance(q, FakeTensor):
        return torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, bool(causal), int(window))
    if q.device.type == "cpu":
        with _COUNT_LOCK:
            plain_calls += 1
        if is_decode(q, k):       # at the slices of an H100 SXM (132 SMs)
            return flash_decode_plain(
                q, k, v, causal=causal, window=window,
                n_split=decode_splits(q.shape[0] * k.shape[1], k.shape[2],
                                      H100_SMS))
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, block_q=block_q,
                                         block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, "
                         f"got {q.device}")
    return _launch(q, k, v, bool(causal), int(window), checked=True)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, checked: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: the route's kernel launch."""
    global launches, fp32_launches, decode_launches
    if not checked:
        _check(q, k, v, window)
    decode = is_decode(q, k)
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd needs a contiguous, "
                             f"16-byte aligned {name}")
    out = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    name = _DECODE_ENTRY if decode else _ENTRY[q.dtype]
    entry = getattr(_build.library(), name)
    stream = _build.stream_handle(q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Sq, Skv, dk, int(bool(causal)),
            int(window), ctypes.c_float(dk ** -0.5))
    with _build.device_guard(q.device):
        if decode:
            n_split = decode_splits(B * Hkv, Skv, device_sms(q.device))
            # the slices' fp32 partials in one workspace: rows x dv of
            # acc, then rows x 2 of (m, l)
            rows = B * Hkv * n_split * (Hq // Hkv) * Sq
            part = torch.empty(rows * (dv + 2), dtype=torch.float32,
                               device=q.device)
            err = entry(*args, part.data_ptr(), part.data_ptr()
                        + 4 * rows * dv, n_split, stream)
        else:
            err = entry(*args, stream)
    _build.check(err, name)
    with _COUNT_LOCK:
        launches += 1
        if q.dtype == torch.float32:
            fp32_launches += 1
        if decode:
            decode_launches += 1
        mode = (bool(causal), Sq == 1)
        mode_launches[mode] = mode_launches.get(mode, 0) + 1
    return out, lse


# ---------------------------------------------------------------------------
# The operator: `torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
# window) -> (out, lse)`, defined with `torch.library.Library` (one schema,
# the CUDA implementation `_launch`, a fake implementation and a FLOP
# formula) rather than `torch.library.custom_op`, whose Python wrapper
# adds more host time still. Tracing (fake tensors) goes through it; the
# wrapper's CUDA route calls `_launch` itself.
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> (Tensor, Tensor)")
_LIB.impl("flash_attention_fwd", _launch, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd", lib=_LIB)
def _launch_fake(q, k, v, causal, window):
    B, Hq, Sq, _ = q.shape
    return (q.new_empty((B, Hq, Sq, v.shape[-1])),
            q.new_empty((B, Hq, Sq), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _launch_flops(q_shape, k_shape, v_shape, causal, window, *args,
                  **kwargs) -> int:
    return bound_flops(q_shape[0], q_shape[1], q_shape[2], k_shape[2],
                       q_shape[3], v_shape[3], causal=causal, window=window)


# ---------------------------------------------------------------------------
# The blockwise forward as one operator for fake tensors:
# `torch.ops.repro_torch.flash_attention_blockwise_fwd(q, k, v, causal,
# window) -> (out, lse)`. Its implementation is `flash_attention_fwd_plain`;
# the dry-run traces it as one op (a 32K-token layer is ~2,100-4,100 block
# pairs of ~15 ops each in the loop) with the loop's exact FLOPs.
# ---------------------------------------------------------------------------

_LIB.define("flash_attention_blockwise_fwd(Tensor q, Tensor k, Tensor v, "
            "bool causal, int window) -> (Tensor, Tensor)")


def _blockwise_impl(q, k, v, causal, window):
    return flash_attention_fwd_plain(q, k, v, causal=causal, window=window)


for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_attention_blockwise_fwd", _blockwise_impl, _key)


@torch.library.register_fake("repro_torch::flash_attention_blockwise_fwd",
                             lib=_LIB)
def _blockwise_fake(q, k, v, causal, window):
    return _launch_fake(q, k, v, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_blockwise_fwd)
def _blockwise_flops(q_shape, k_shape, v_shape, causal, window, *args,
                     **kwargs) -> int:
    return blockwise_flops(q_shape[0], q_shape[1], q_shape[2], k_shape[2],
                           q_shape[3], v_shape[3], causal=causal,
                           window=window)


def _blockwise_workspace(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> list[torch.Tensor]:
    """Tensors of the size the block loop holds besides its inputs and
    outputs at its peak: fp32 copies of q, k and v (none for fp32 inputs),
    the (B, Hkv, G, bq, dv) accumulator with its running max and sum, and
    four fp32 score blocks (s, s - m, p and p masked)."""
    B, Hq, Sq, _ = q.shape
    Skv, dv = k.shape[2], v.shape[-1]
    bq, bk = min(DEFAULT_BLOCK_Q, Sq), min(DEFAULT_BLOCK_K, Skv)
    f32 = torch.float32
    ws = [] if q.dtype == f32 else [
        torch.empty_like(t, dtype=f32) for t in (q, k, v)]
    ws.append(q.new_empty((B, Hq, bq, dv + 2), dtype=f32))
    ws.append(q.new_empty((4, B, Hq, bq, bk), dtype=f32))
    return ws


def flash_attention_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blockwise forward (head dims without a kernel): a real tensor,
    on either device, runs `flash_attention_fwd_plain`; a fake tensor (the
    dry-run's) takes the operator `torch.ops.repro_torch.
    flash_attention_blockwise_fwd`, one traced op with the loop's FLOPs.
    Around that call it holds `_blockwise_workspace`, so that a
    `MemTracker` above the fake mode sees the loop's peak: what a fake
    implementation allocates runs beneath the dispatch modes, where no
    tracker sees it."""
    if isinstance(q, FakeTensor):
        ws = _blockwise_workspace(q, k, v)
        out = torch.ops.repro_torch.flash_attention_blockwise_fwd(
            q, k, v, bool(causal), int(window))
        del ws
        return out
    return flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
