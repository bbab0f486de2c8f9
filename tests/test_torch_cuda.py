"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Byte equality for the coding kernels (GF(2^8) coding is exact);
attention within 2e-2 in bf16 (the decode kernel against both plain
versions; 2e-3 on out and 1e-3 on lse over 1,000 keys and more) and 2e-5
(out) / 1e-4 (lse) in fp32; the flash layer's gradient and a train step
on the card within 2e-2.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports nothing of the reference package, so it runs on a machine without
jax:  python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import make_unilrc
from repro_torch.core.codec import decode_plan
from repro_torch.core.gf import gf_bit_columns
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import gf_bitmatmul as gfk
from repro_torch.kernels import xor_reduce as xrk
from repro_torch.models import layers
from repro_torch.models import (ModelConfig, forward, init_params,
                                pad_cache_to, params_from_jax, params_to_tree,
                                uniform_segments)

from mla_absorbed import absorbed_prefill

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bytes(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


GF_CASES = [
    (1, 1, 1, 1, "random", 0), (3, 1, 20, 3000, "random", 0),
    (2, 21, 180, 4096, "random", 0), (8, 30, 180, 65536, "random", 0),
    (2, 17, 33, 1000, "random", 0), (1, 40, 9, 160, "random", 0),
    # the encode code: N = 240, the 1,440 bit columns in two passes
    (2, 30, 180, 4096, "encode", 0),
    # the cluster-decode plan: N padded from 168 to 176, two passes
    (2, 21, 180, 4096, "cluster", 0),
    # delta terms over four and two N tiles
    (1, 105, 5, 4096, "random", 0), (1, 42, 2, 4096, "random", 0),
    # one output row; K padded from 8 to 32 bit columns
    (2, 1, 20, 4096, "random", 0), (2, 1, 1, 1000, "random", 0),
    # a ragged width and an unaligned base take the wrapper's aligned copy
    (2, 30, 180, 4097, "encode", 0), (2, 30, 180, 4097, "encode", 1),
    # the serve save's batch of 36 stripes
    (36, 30, 180, 256, "encode", 0),
]


# (S, m, k, B): the encode, the cluster decode, the delta terms (one and
# two N tiles, four N tiles), a ragged width, fewer tiles than SMs
GF_PLAN_SHAPES = [(8, 30, 180, 1 << 20), (23, 21, 180, 1 << 20),
                  (1, 21, 1, 1 << 20), (1, 42, 2, 1 << 20),
                  (1, 105, 5, 4096), (2, 30, 180, 4097), (1, 1, 20, 1000)]


@pytest.mark.parametrize("S,m,k,B", GF_PLAN_SHAPES)
def test_matmul_plan_is_the_kernels_own_plan(card, S, m, k, B):
    """`autotune.matmul_plan` against the plan the host code of
    `gf_matmul_sm90.cu` makes for the same shape on this card
    (`repro_gf_plan`, which launches nothing), field by field."""
    from repro_torch.kernels import autotune

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    got = gfk.host_plan(S, m, k, B)
    plan = autotune.matmul_plan(k, m, B, S=S, sms=sms)
    want = autotune.kernel_plan(m, k)
    assert (got["threads"], got["grid"], got["smem"], got["k_passes"],
            got["N"]) == (plan.threads, plan.grid_steps, plan.smem_bytes,
                          plan.passes, plan.n_width)
    assert (got["n_tiles"], got["rows_per_tile"], got["steps_per_pass"]) \
        == (want["n_tiles"], want["rows_per_tile"], want["steps_per_pass"])


def _matrix(kind, m, k):
    if kind == "random":
        return _bytes(m * k, (m, k)).numpy()
    code = make_unilrc(2, 10)
    M = code.A if kind == "encode" else \
        decode_plan(code, code.groups[0]).M
    assert M.shape == (m, k)
    return M


@pytest.mark.parametrize("S,m,k,B,kind,offset", GF_CASES)
def test_gf_matches_plain(card, S, m, k, B, kind, offset):
    cols = torch.from_numpy(gf_bit_columns(_matrix(kind, m, k)))
    flat = _bytes(B, (S * k * B + offset,))
    data = flat[offset:].view(S, k, B)
    # repro-lint: allow=RA001
    got = gfk.gf_bitmatmul(cols.to(card), flat.to(card)[offset:].view(S, k, B))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gfk.gf_bitmatmul_plain(cols, data))


def test_gf_call_is_one_launch_of_the_tensor_core_kernel(card):
    """One call on aligned data counts one launch, runs one device kernel
    and it is `gf_matmul_sm90_kernel`."""
    from torch.profiler import ProfilerActivity, profile
    cols = torch.from_numpy(gf_bit_columns(_matrix("encode", 30, 180)))
    data = _bytes(7, (2, 180, 4096)).to(card)
    cols = cols.to(card)
    # repro-lint: allow=RA001
    gfk.gf_bitmatmul(cols, data)                       # built and warm
    torch.cuda.synchronize()
    before = (gfk.launches, gfk.plain_calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gfk.gf_bitmatmul(cols, data)  # repro-lint: allow=RA001
        torch.cuda.synchronize()
    assert (gfk.launches, gfk.plain_calls) == (before[0] + 1, before[1])
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memset" not in e.name.lower()
               and "memcpy" not in e.name.lower()]
    assert len(kernels) == 1 and "gf_matmul_sm90_kernel" in kernels[0], \
        kernels


def test_gf_unaligned_view_and_decode_matrix(card):
    code = make_unilrc(2, 10)
    plan = decode_plan(code, code.groups[0])          # a lost cluster
    assert plan.M.shape[0] == 21
    cols = torch.from_numpy(gf_bit_columns(plan.M))
    k = plan.M.shape[1]
    flat = _bytes(1, (2 * k * 2048 + 1,))
    view = flat[1:].view(2, k, 2048)                  # 1-byte offset base
    # repro-lint: allow=RA001
    got = gfk.gf_bitmatmul(cols.to(card), flat.to(card)[1:].view(2, k, 2048))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gfk.gf_bitmatmul_plain(cols, view))


@pytest.mark.parametrize("S,s,B", [(1, 1, 5), (1, 2, 3000), (23, 20, 65536),
                                   (4, 29, 4097)])
def test_xor_matches_plain(card, S, s, B):
    blocks = _bytes(s * B, (S, s, B))
    got = xrk.xor_reduce(blocks.to(card))  # repro-lint: allow=RA001
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), xrk.xor_reduce_plain(blocks))


def test_wrappers_count_launches_only_on_the_card(card):
    gfk.reset_counts()
    xrk.reset_counts()
    x = _bytes(0, (1, 3, 64)).to(card)
    xrk.xor_reduce(x)  # repro-lint: allow=RA001
    # repro-lint: allow=RA001
    gfk.gf_bitmatmul(torch.ones((1, 3, 8), dtype=torch.uint8, device=card), x)
    assert (xrk.launches, xrk.plain_calls) == (1, 0)
    assert (gfk.launches, gfk.plain_calls) == (1, 0)


# causal, window, B, Hq, Hkv, Sq, Skv, d, dtype
FLASH_CASES = [
    (True, 0, 1, 4, 1, 1000, 1000, 128, torch.bfloat16),   # ragged, G=4
    (True, 512, 2, 8, 2, 2048, 2048, 128, torch.bfloat16),  # window
    (False, 0, 1, 2, 2, 100, 333, 64, torch.bfloat16),     # Sq != Skv
    (True, 0, 2, 8, 2, 1, 1, 128, torch.bfloat16),         # one token
    (True, 0, 1, 2, 1, 256, 256, 128, torch.float32),
    (True, 128, 1, 4, 2, 300, 300, 64, torch.float32),     # window, ragged
    # the bf16 kernel's tile edges: 128 query rows a CTA, 128-key tiles
    (True, 0, 1, 4, 1, 127, 127, 128, torch.bfloat16),
    (True, 0, 1, 4, 1, 128, 128, 128, torch.bfloat16),
    (True, 0, 1, 4, 1, 129, 129, 128, torch.bfloat16),
    (True, 0, 1, 4, 1, 129, 129, 64, torch.bfloat16),
    (False, 0, 2, 4, 4, 129, 129, 128, torch.bfloat16),    # G=1
    (True, 0, 1, 16, 2, 300, 300, 128, torch.bfloat16),    # G=8
    (True, 200, 1, 4, 2, 700, 700, 128, torch.bfloat16),   # window over tiles
    (True, 0, 1, 2, 1, 4096, 4096, 128, torch.bfloat16),   # the ring wraps 16x
    # non-causal window past the keys: rows (and, at Sq=400, whole q
    # tiles) that see no key write out = 0 and lse = -inf
    (False, 4, 1, 2, 1, 40, 8, 64, torch.bfloat16),
    (False, 4, 1, 2, 1, 400, 8, 128, torch.bfloat16),
    # head dim 256 (recurrentgemma's local attention, MQA): the serve
    # shape, then the 64-key tile's edges, the 128-row q tile's edges, a
    # window narrower than a key tile, Sq != Skv, one token, dead rows
    (True, 2048, 2, 16, 1, 3968, 3968, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 63, 63, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 64, 64, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 65, 65, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 127, 127, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 128, 128, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 129, 129, 256, torch.bfloat16),
    (True, 40, 1, 16, 1, 300, 300, 256, torch.bfloat16),
    (False, 0, 1, 4, 2, 100, 333, 256, torch.bfloat16),
    (True, 0, 2, 16, 1, 1, 1, 256, torch.bfloat16),
    (False, 4, 1, 2, 1, 400, 8, 256, torch.bfloat16),
    # the fp32 kernel (3xTF32 on the tensor cores) at head dim 256: the
    # recurrentgemma prefill shape, the 32-key tile's edges, the 64-row q
    # tile's edges, a window narrower than a key tile, Sq != Skv, one
    # token, rows that see no key
    (True, 2048, 2, 16, 1, 3968, 3968, 256, torch.float32),
    (True, 0, 1, 4, 1, 31, 31, 256, torch.float32),
    (True, 0, 1, 4, 1, 32, 32, 256, torch.float32),
    (True, 0, 1, 4, 1, 33, 33, 256, torch.float32),
    (True, 0, 1, 4, 1, 63, 63, 256, torch.float32),
    (True, 0, 1, 4, 1, 64, 64, 256, torch.float32),
    (True, 0, 1, 4, 1, 65, 65, 256, torch.float32),
    (True, 20, 1, 16, 1, 300, 300, 256, torch.float32),
    (False, 0, 1, 4, 2, 100, 333, 256, torch.float32),
    (True, 0, 2, 16, 1, 1, 1, 256, torch.float32),
    (False, 4, 1, 2, 1, 40, 8, 256, torch.float32),
    # and at 64 and 128 on the same tiles' edges, with G = 8
    (True, 0, 1, 16, 2, 31, 31, 64, torch.float32),
    (True, 0, 1, 16, 2, 33, 33, 64, torch.float32),
    (True, 0, 1, 16, 2, 65, 65, 64, torch.float32),
    (True, 0, 1, 16, 2, 32, 32, 128, torch.float32),
    (True, 0, 1, 16, 2, 63, 63, 128, torch.float32),
    (True, 0, 1, 16, 2, 129, 129, 128, torch.float32),
    (False, 4, 1, 16, 2, 400, 8, 128, torch.float32),
]


def _qkv(seed, B, Hq, Hkv, Sq, Skv, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
            for sh in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]


@pytest.mark.parametrize("causal,window,B,Hq,Hkv,Sq,Skv,d,dtype",
                         FLASH_CASES)
def test_flash_matches_plain(card, causal, window, B, Hq, Hkv, Sq, Skv, d,
                             dtype):
    q, k, v = (t.to(card) for t in _qkv(Sq, B, Hq, Hkv, Sq, Skv, d, dtype))
    out, lse = fak.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=window)
    torch.cuda.synchronize()
    tol, lse_tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-5, 1e-4)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - want.float()).abs().max().item() <= tol
    # rows that see no key: lse is -inf in both, and nowhere else
    dead = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert (lse - want_lse)[~dead].abs().max().item() <= lse_tol


@pytest.mark.parametrize("Sq", [2048, 1])
def test_flash_cross_attention_shapes_see_an_unmasked_tail(card, Sq):
    """llama-3.2-vision's cross-attention: not causal over 6404 = 50 x 128
    + 4 vision keys, at prefill (Sq = 2048) and decode (Sq = 1). Over
    6404 keys |out| ~ 0.02, so the bf16 cases' 2e-2 bounds would pass
    anything: out is held to 2e-3 and lse to 1e-3 (measured on an H100:
    4.9e-4 and 9.5e-6). The plain version over the keys padded with zeros
    to the next 128-key tile, the padding not masked, as a kernel that
    forgot the tail mask would compute, must fail those bounds (lse moves
    by ~1.2e-2)."""
    tol, lse_tol = 2e-3, 1e-3
    q, k, v = (t.to(card) for t in _qkv(Sq, 4, 32, 8, Sq, 6404, 128,
                                        torch.bfloat16))
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v, causal=False)
    # the decode (Sq = 1: 4 rows a kv head) takes the split-KV kernel
    assert (fak.launches, fak.decode_launches) == (1, int(Sq == 1))
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=False)
    kz, vz = (torch.nn.functional.pad(t, (0, 0, 0, 124)) for t in (k, v))
    bad, bad_lse = fak.flash_attention_fwd_plain(q, kz, vz, causal=False)
    torch.cuda.synchronize()
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= lse_tol
    assert ((bad.float() - want.float()).abs().max().item() > tol
            or (bad_lse - want_lse).abs().max().item() > lse_tol)


# the split-KV decode kernel (bf16, Hq / Hkv x Sq <= 16 rows a kv head)
# at phase 3's decode shapes, B = 1: the vision heads (G = 4) over Skv 1,
# 127, 6404 and 32768; G = 1 and 16 (recurrentgemma's 16 / 1 at d = 256);
# d = 64 and 256; masks at Sq = 4 (rows past the keys see none, the causal
# triangle leaves most slices empty); G x Sq at the cap
# B, Hq, Hkv, Sq, Skv, d, causal, window
DECODE_CASES = [
    (1, 32, 8, 1, 1, 128, False, 0), (1, 32, 8, 1, 127, 128, False, 0),
    (1, 32, 8, 1, 6404, 128, False, 0), (1, 32, 8, 1, 32768, 128, False, 0),
    (1, 32, 32, 1, 6404, 128, False, 0), (1, 16, 1, 1, 3968, 256, False, 0),
    (1, 32, 8, 1, 6404, 64, False, 0), (1, 32, 8, 1, 6404, 256, False, 0),
    (2, 8, 2, 4, 2, 128, True, 2), (1, 8, 2, 4, 300, 64, True, 0),
    (1, 8, 2, 4, 300, 256, False, 3), (1, 32, 8, 4, 6404, 128, False, 0),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d,causal,window", DECODE_CASES)
def test_flash_decode_matches_both_plain_versions(card, B, Hq, Hkv, Sq, Skv,
                                                  d, causal, window):
    """One launch of the decode kernel, within the bf16 bounds of the
    prefill plain version and of `flash_decode_plain` at the kernel's own
    n_split; rows that see no key are -inf in all three. Over 1,000 keys
    and more |out| is ~0.01-0.03, so there the bounds are 2e-3 on out and
    1e-3 on lse (chip_smoke.py's CROSS_TOLS), not the bf16 2e-2."""
    tol, lse_tol = (2e-3, 1e-3) if Skv >= 1000 else (2e-2, 2e-2)
    q, k, v = (t.to(card) for t in _qkv(Skv, B, Hq, Hkv, Sq, Skv, d,
                                        torch.bfloat16))
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fak.launches, fak.decode_launches, fak.plain_calls) == (1, 1, 0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n_split = fak.decode_splits(B * Hkv, Skv, sms)
    for want, want_lse in (
            fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                          window=window),
            fak.flash_decode_plain(q, k, v, causal=causal, window=window,
                                   n_split=n_split)):
        dead = torch.isneginf(want_lse)
        assert torch.equal(torch.isneginf(lse), dead)
        assert (out.float() - want.float()).abs().max().item() <= tol
        if not dead.all():
            assert (lse - want_lse)[~dead].abs().max().item() <= lse_tol
        assert (out[dead] == 0).all()


@pytest.mark.parametrize("G,Sq,decode", [(4, 4, True), (4, 5, False),
                                         (16, 1, True), (1, 17, False)])
def test_flash_decode_cap_picks_the_kernel(card, G, Sq, decode):
    """G x Sq <= DECODE_ROWS launches the decode kernel (and not the
    prefill kernel); one row group past it launches the prefill kernel.
    Both count in `launches` and in `mode_launches`."""
    q, k, v = (t.to(card) for t in _qkv(5, 1, 2 * G, 2, Sq, 500, 128,
                                        torch.bfloat16))
    fak.reset_counts()
    out, _ = fak.flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (fak.launches, fak.decode_launches, fak.plain_calls) == \
        (1, int(decode), 0)
    assert fak.mode_launches == {(False, Sq == 1): 1}
    want, _ = fak.flash_attention_fwd_plain(q, k, v, causal=False)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2


def test_launches_go_to_the_current_stream(card):
    """`_build.stream_handle` is the current stream's handle, on the
    default stream and inside `torch.cuda.stream`, and a decode launched
    on a side stream there gives the default stream's result."""
    from repro_torch.kernels import _build

    for device in (card, torch.device("cuda", torch.cuda.current_device())):
        assert _build.stream_handle(device) == \
            torch.cuda.current_stream(device).cuda_stream
    q, k, v = (t.to(card) for t in _qkv(2, 1, 8, 2, 1, 300, 128,
                                        torch.bfloat16))
    want, want_lse = fak.flash_attention_fwd(q, k, v, causal=False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _build.stream_handle(card) == side.cuda_stream
        out, lse = fak.flash_attention_fwd(q, k, v, causal=False)
    side.synchronize()
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


def test_flash_decode_failures_raise(card, monkeypatch):
    """No fallback: a launch the C entry refuses (here n_split 0) and a
    failed build both raise, and neither counts a launch or a plain
    call."""
    from repro_torch.kernels import _build

    q, k, v = (t.to(card) for t in _qkv(0, 1, 8, 2, 1, 300, 128,
                                        torch.bfloat16))
    fak.reset_counts()
    with monkeypatch.context() as m:
        m.setattr(fak, "decode_splits", lambda *a: 0)
        with pytest.raises(RuntimeError, match="repro_flash_decode_bf16"):
            fak.flash_attention_fwd(q, k, v, causal=False)

    def broken():
        raise RuntimeError("nvcc failed on flash_decode_sm90.cu")
    with monkeypatch.context() as m:
        m.setattr(_build, "library", broken)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fak.flash_attention_fwd(q, k, v, causal=False)
    assert (fak.launches, fak.decode_launches, fak.plain_calls) == (0, 0, 0)


@pytest.mark.parametrize("d,dtype,item", [
    (96, torch.bfloat16, "ROADMAP C1"),     # no kernel; the layer routes it
    (384, torch.bfloat16, "ROADMAP C1"),    # a multiple of 128, no kernel
    (384, torch.float32, "ROADMAP C1"),     # no fp32 kernel either
])
def test_flash_head_dim_outside_the_kernel_raises(card, d, dtype, item):
    q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, 64, 64, d, dtype))
    fak.reset_counts()
    with pytest.raises(NotImplementedError, match=item):
        fak.flash_attention_fwd(q, k, v)
    assert (fak.launches, fak.plain_calls) == (0, 0)


def test_flash_counts_launches_only_on_the_card(card):
    fak.reset_counts()
    q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, 64, 64, 64,
                                        torch.bfloat16))
    fak.flash_attention_fwd(q, k, v)
    assert (fak.launches, fak.fp32_launches, fak.plain_calls) == (1, 0, 0)


def test_flash_counts_launches_by_mode(card):
    """`mode_launches` keys each launch by (causal, Sq == 1): a causal
    prefill, a cross-attention prefill and a decode step; a CPU call
    counts in none."""
    fak.reset_counts()
    for causal, Sq in ((True, 64), (False, 64), (False, 1), (False, 1)):
        q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, Sq, 64, 64,
                                            torch.bfloat16))
        fak.flash_attention_fwd(q, k, v, causal=causal)
    fak.flash_attention_fwd(*_qkv(0, 1, 2, 1, 8, 8, 64, torch.bfloat16))
    assert fak.mode_launches == {(True, False): 1, (False, False): 1,
                                 (False, True): 2}
    assert (fak.launches, fak.plain_calls) == (4, 1)
    fak.reset_counts()
    assert fak.mode_launches == {}


def test_fp32_flash_counts_its_own_launches(card):
    """An fp32 call launches `flash_fwd_f32_sm90_kernel` (3xTF32 on the
    tensor cores): it counts in `launches` and in `fp32_launches`, and its
    result is the plain version's."""
    q, k, v = (t.to(card) for t in _qkv(3, 1, 4, 2, 200, 200, 128,
                                        torch.float32))
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fak.launches, fak.fp32_launches, fak.plain_calls) == (1, 1, 0)
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v)
    assert (out - want).abs().max().item() <= 2e-5
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_bf16_flash_is_one_launch_of_the_hopper_kernel(card):
    """A bf16 call at the serving head dim counts one launch and no plain
    call, and its result is the plain version's."""
    q, k, v = (t.to(card) for t in _qkv(1, 2, 8, 2, 300, 300, 128,
                                        torch.bfloat16))
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls) == (1, 0)
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 2e-2


def test_smoke_model_on_the_card_matches_the_cpu(card):
    """A 2-layer model with head dim 64 (ghost heads 6 -> 8) on the card
    against the same weights on the CPU: logits within 5e-2 of max |logit|
    (bf16 matmuls round in other places on the two devices)."""
    cfg = ModelConfig(name="cuda-smoke", family="dense", d_model=384,
                      num_heads=6, num_kv_heads=2, d_ff=512, vocab_size=512,
                      segments=uniform_segments("attn", 2),
                      rope_theta=10000.0, tie_embeddings=True, tp_pad_heads=4)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (2, 100)))
    fak.reset_counts()
    got, _, _ = forward(dev, tokens.to(card), mode="train")
    assert (fak.launches, fak.plain_calls) == (2, 0)
    want, _, _ = forward(host, tokens, mode="train")
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale

    _, cache, _ = forward(dev, tokens[:, :99].to(card), mode="prefill")
    cache = pad_cache_to(cache, cfg, 104)
    step, _, _ = forward(dev, tokens[:, 99:].to(card), mode="decode",
                         cache=cache, pos=99)
    assert (step[:, 0].cpu().float() - want[:, -1].float()).abs().max() \
        .item() < 5e-2 * scale


@pytest.mark.parametrize("head_dim", [16, 256])
def test_recurrentgemma_smoke_on_the_card_matches_the_cpu(card, head_dim):
    """recurrentgemma SMOKE (rg, rg, local_attn, rg, rg; window 8) on the
    card against the same weights on the CPU, 40 tokens: train logits, and
    prefill + decode steps past the window, within 5e-2 of max |logit|.
    At head dim 16 the local attention runs blockwise; at 256 it launches
    the flash kernel, once per prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, layers

    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              head_dim=head_dim)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 40)))
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, _, _ = forward(dev, tokens.to(card), mode="train")
    want, _, _ = forward(host, tokens, mode="train")
    kernel = head_dim == 256
    assert (fak.launches, layers.blockwise_calls) == \
        ((1, 0) if kernel else (0, 2))      # host: blockwise at 16
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale

    # prefill 30, then 10 decode steps (past the window of 8) on the card
    _, cache, _ = forward(dev, tokens[:, :30].to(card), mode="prefill")
    cache = pad_cache_to(cache, cfg, 40)
    for i in range(30, 40):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
        assert (step[:, 0].cpu().float() - want[:, i].float()).abs().max() \
            .item() < 5e-2 * scale
    # and from a zeroed cache on the card, token by token
    cache = init_cache(cfg, 2, 40, device=card)
    for i in range(12):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
    assert (step[:, 0].cpu().float() - want[:, 11].float()).abs().max() \
        .item() < 5e-2 * scale


def test_mla_smoke_on_the_card_matches_the_cpu(card):
    """minicpm3 SMOKE with ghost heads (4 -> 8) on the card against the
    same weights on the CPU, 40 tokens: train logits, and a prefill of 30
    then 10 decode steps against the latent cache, within 5e-2 of max
    |logit|. Train and prefill attend in the per-head form, (16 + 8, 16)
    zero-padded to 64: the flash kernel once a layer on the card, its
    plain version on the CPU; decode on the absorbed latent cache."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("minicpm3-4b", smoke=True),
                              name="minicpm3-ghost", tp_pad_heads=8)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 40)))
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, _, _ = forward(dev, tokens.to(card), mode="train")
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == \
        (2, 0, 0)
    want, _, _ = forward(host, tokens, mode="train")
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale
    _, cache, _ = forward(dev, tokens[:, :30].to(card), mode="prefill")
    assert cache[0][0]["ckv"].device.type == "cuda"
    cache = pad_cache_to(cache, cfg, 40)
    for i in range(30, 40):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
        assert (step[:, 0].cpu().float() - want[:, i].float()).abs().max() \
            .item() < 5e-2 * scale


def test_mla_per_head_prefill_at_full_width_on_the_card(card):
    """One minicpm3-4b MLA layer at its full widths (48 heads, q and k
    64 + 32, v 64, padded to the kernel's 128) on a 2,048-token causal
    prefill: the per-head form launches the flash kernel once, nothing
    blockwise, and its output matches the absorbed form's (blockwise on
    the card) within 2e-2 of max |out|."""
    from repro_torch.configs import get_config

    cfg = get_config("minicpm3-4b")
    m = layers.MLA(cfg, torch.Generator().manual_seed(0), "cpu").to(card)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 2048, cfg.d_model)).astype(np.float32)).to(card).bfloat16()
    with torch.inference_mode():
        layers.reset_blockwise_calls()
        _, want = absorbed_prefill(m, x, cfg)
        assert layers.blockwise_calls == 1
        fak.reset_counts()
        layers.reset_blockwise_calls()
        layers.reset_mla_per_head_calls()
        got, cache = layers.mla_block(m, x, cfg, "prefill", None, None)
        torch.cuda.synchronize()
    assert (fak.launches, fak.decode_launches, fak.plain_calls,
            layers.blockwise_calls, layers.mla_per_head_calls) == \
        (1, 0, 0, 0, 1)
    assert fak.mode_launches == {(True, False): 1}
    assert tuple(cache["ckv"].shape) == (1, 2048, cfg.mla.kv_lora_rank)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_moe_smoke_on_the_card_matches_the_cpu(card, arch):
    """An MoE SMOKE model on the card against the same weights on the CPU,
    in fp32 on both (routing is discontinuous: in bf16 the two devices'
    roundings can switch the expert of a token whose router
    probabilities nearly tie): train logits and aux, a prefill of 20 and
    4 decode steps, within 1e-3 of max |logit| (fp32 products in another
    order) and aux within 1e-4 relative. Then in bf16, as served: finite
    logits and a positive aux on the card."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, 512, (2, 24)))
    got, _, aux = forward(dev, tokens.to(card), mode="train")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(
        got.float()).all()) and float(aux) > 0
    host32, dev32 = host.float(), dev.float()
    want, _, want_aux = forward(host32, tokens, mode="train")
    got, _, aux = forward(dev32, tokens.to(card), mode="train")
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() < 1e-3 * scale
    assert abs(float(aux) - float(want_aux)) <= 1e-4 * float(want_aux)
    # the same prefill and decode steps on both devices (a decode step
    # routes one token, with no capacity to drop it: it is compared with
    # the other device's decode step, not with a prefill)
    _, cache, _ = forward(dev32, tokens[:, :20].to(card), mode="prefill")
    _, host_cache, _ = forward(host32, tokens[:, :20], mode="prefill")
    cache = pad_cache_to(cache, cfg, 24)
    host_cache = pad_cache_to(host_cache, cfg, 24)
    for i in range(20, 24):
        step, cache, _ = forward(dev32, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
        want_i, host_cache, _ = forward(host32, tokens[:, i:i + 1],
                                        mode="decode", cache=host_cache,
                                        pos=i)
        assert (step[:, 0].cpu() - want_i[:, 0]).abs().max().item() < \
            1e-3 * scale


def test_moe_combine_is_deterministic_on_the_card(card):
    """The MoE FFN at phi3.5-moe's SMOKE width on the card, twice on the
    same input: the same bits (the combine gathers each token's slots and
    adds them in expert order; no atomics), and within 2e-2 of the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    host = layers.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = layers.MoE(cfg, device=card)
    dev.load_state_dict(host.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 256, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        a, aux_a = layers.moe_ffn(dev, x.to(card), cfg)
        b, aux_b = layers.moe_ffn(dev, x.to(card), cfg)
        want, _ = layers.moe_ffn(host, x, cfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert float(aux_a) == float(aux_b)
    scale = want.float().abs().max().item()
    assert (a.cpu().float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("d", [16, 80])
def test_layer_off_the_kernel_head_dims_on_the_card(card, d):
    """A head dim the flash kernel lacks goes through the layer on the card
    blockwise (no launch, no raise) and matches the kernel's plain version
    on the CPU within the bf16 tolerance of FLASH_CASES."""
    from repro_torch.models import layers

    q, k, v = _qkv(d, 2, 8, 2, 300, 300, d, torch.bfloat16)
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = layers.flash_attention(q.to(card), k.to(card), v.to(card),
                                 causal=True)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == \
        (0, 0, 1)
    want, _ = fak.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.cpu().float() - want.float()).abs().max().item() <= 2e-2


def test_layer_head_dim_256_on_the_card_launches_the_kernel(card):
    """dk = dv = 256 is a multiple of 128, which the reference hands its
    Pallas kernel: the layer hands it to the flash wrapper, which launches
    the Hopper kernel once (no blockwise call, no plain call), windowed as
    recurrentgemma's local attention is."""
    from repro_torch.models import layers

    q, k, v = (t.to(card) for t in _qkv(0, 1, 4, 1, 300, 300, 256,
                                        torch.bfloat16))
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = layers.flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == \
        (1, 0, 0)
    want, _ = fak.flash_attention_fwd_plain(q, k, v, causal=True, window=100)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2


def test_serve_smoke_arch_on_the_card(card):
    """`python -m repro_torch.launch.serve --arch llama3.2-3b` on the card:
    the SMOKE config (head dim 16) serves blockwise, with no flash launch."""
    from repro_torch.launch import serve
    from repro_torch.models import layers

    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = serve.run(["--arch", "llama3.2-3b", "--requests", "1",
                     "--prompt-len", "8", "--gen", "2"])
    assert [tuple(t.shape) for t in out["tokens"]] == [(1, 2)]
    assert (fak.launches, fak.plain_calls) == (0, 0)
    assert layers.blockwise_calls >= 1


def test_lifetime_sampler_on_the_card(card):
    """The simulator's initial lifetimes drawn on the card: equal per
    generator seed, float64 on the host, and the sample mean within 3
    standard errors of the hazard's mean."""
    from repro_torch.sim import Weibull, exponential_from_mttf_years
    from repro_torch.sim import sample_lifetimes

    def draw(hazard, seed, shape):
        gen = torch.Generator(device=card)
        gen.manual_seed(seed)
        return sample_lifetimes(hazard, gen, shape, device=card)

    for hazard in (exponential_from_mttf_years(0.5),
                   Weibull(shape=0.7, scale=4000.0)):
        a, b = draw(hazard, 7, (400, 240)), draw(hazard, 7, (400, 240))
        assert a.shape == (400, 240) and a.dtype == np.float64
        assert np.array_equal(a, b)
        assert not np.array_equal(a, draw(hazard, 8, (400, 240)))
        x = draw(hazard, 1, (200_000,))
        se = x.std(ddof=1) / np.sqrt(x.size)
        assert abs(x.mean() - hazard.mean_hours) < 3 * se


def test_data_path_trial_on_the_card(card):
    """A data-path `DssTrial` on the card: churn with real repairs through
    the coding kernels, every launch one plan group, no plain version, and
    the payload read back byte for byte."""
    from repro_torch.core import MTTDLParams
    from repro_torch.kernels import ops
    from repro_torch.sim import DssTrial, SimConfig, sample_lifetimes

    params = MTTDLParams(N=4, S_TB=1.0, epsilon=0.5, delta=0.5,
                         T_hours=48.0, B_Gbps=1.0, node_mttf_years=0.5)
    cfg = SimConfig(code=make_unilrc(1, 4), params=params, n_stripes=6,
                    trials=1, seed=3, mission_hours=2000.0, data_path=True,
                    block_size=4096, device="cuda")
    nodes = cfg.resolved_placement().num_clusters * cfg.resolved_npc()
    gen = torch.Generator(device=card)
    gen.manual_seed(cfg.seed)
    init = sample_lifetimes(cfg.resolved_failure_model().node, gen,
                            (1, nodes), device=card)
    gfk.reset_counts()
    xrk.reset_counts()
    trial = DssTrial(cfg, 0, init[0])
    assert trial.codec.backend.device.type == "cuda"
    before = sum(ops.KERNEL_LAUNCHES.values())
    res = trial.run()
    ledger = trial.scheduler.ledger
    assert not res.lost and res.repaired_blocks > 0
    assert ledger.kernel_launches == ledger.plan_groups > 0
    assert sum(ops.KERNEL_LAUNCHES.values()) - before == ledger.kernel_launches
    assert xrk.launches > 0
    assert gfk.plain_calls == xrk.plain_calls == 0
    assert trial.codec.read_all(trial.metas) == trial.payload


# ---------------------------------------------------------------------------
# training: the flash layer's gradient, train steps, the training CLI
# ---------------------------------------------------------------------------

def _naive_attention(q, k, v, causal, window):
    """fp32 softmax attention with GQA, every score materialised."""
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    qp = torch.arange(q.shape[2], device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None]
    mask = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    return torch.softmax(s.masked_fill(~mask, -torch.inf), -1) @ v


@pytest.mark.parametrize("window", [0, 128])
def test_flash_layer_gradient_on_the_card(card, window):
    """dq, dk, dv through `layers.flash_attention` (kernel forward, one
    launch, then the blockwise backward) against (a) the same backward
    from the plain forward's out and lse, and (b) fp32 autograd through
    naive attention: within 2e-2 of max |grad|."""
    q, k, v = (t.to(card) for t in _qkv(9, 1, 4, 2, 512, 512, 128,
                                        torch.bfloat16))
    do = torch.randn(q.shape, generator=torch.Generator(card).manual_seed(1),
                     device=card).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fak.reset_counts()
    out = layers.flash_attention(*leaves, causal=True, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls) == (1, 0)
    got = [t.grad for t in leaves]
    p_out, p_lse = fak.flash_attention_fwd_plain(q, k, v, causal=True,
                                                 window=window)
    plain = layers.flash_attention_bwd(q, k, v, p_out, p_lse, do,
                                       causal=True, window=window)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    _naive_attention(*ref, True, window).backward(do.float())
    for g, a, b in zip(got, plain, (t.grad for t in ref)):
        assert g.dtype == torch.bfloat16
        scale = b.abs().max().item()
        assert (g.float() - a.float()).abs().max().item() <= 2e-2 * scale
        assert (g.float() - b).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi4-mini-3.8b",
                                  "qwen1.5-32b", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """One `make_train_step` (accum 2, remat) from the same state on the
    card and on the CPU: loss and grad norm within 2e-2 relative, and the
    gradient itself leaf by leaf: after the first step the first moment
    m is (1 - b1) x the clipped gradient, and each leaf's m on the card
    is within 2e-2 of that leaf's max |m| on the CPU. (The parameters
    are no witness: the first AdamW step moves every element by about
    lr x sign(grad) whatever the gradient's size.)

    phi3.5-moe's m is compared with every leaf in fp32 on both devices:
    in bf16 the two devices' roundings switch the expert of a token whose
    router probabilities nearly tie (measured on the H100: 2 of 256
    tokens, 2nd and 3rd probability 0.24114 and 0.24027 on the CPU,
    reversed on the card), which moves the router's and the experts' m by
    up to 6.4e-2 of their max; in fp32 no token switches. Its bf16 step
    is held to the loss and grad norm bound."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_from_jax,
                                   train_state_to_tree)
    cfg = get_config(arch, smoke=True)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    step = make_train_step(cfg, ocfg, TrainConfig(accum=2, remat="block"))
    tokens, labels = SyntheticTokenDataset(
        DataConfig(cfg.vocab_size, 64, 4)).batch(0)
    for fp32 in ((False, True) if cfg.moe else (False,)):
        host = init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")
        dev = train_state_from_jax(cfg, train_state_to_tree(host), card)
        if fp32:
            host.model.float()
            dev.model.float()
        host, want = step(host, tokens, labels)
        dev, got = step(dev, tokens, labels)
        for key in ("loss", "grad_norm"):
            assert abs(float(got[key]) - float(want[key])) <= \
                2e-2 * abs(float(want[key])), key
    for a, b in zip(host.params, dev.params):
        assert b.device.type == "cuda" and a.dtype == b.dtype
    names = [n for n, _ in host.model.named_parameters()]
    for name, a, b in zip(names, host.opt["m"], dev.opt["m"]):
        assert b.device.type == "cuda" and b.dtype == torch.float32
        scale = a.abs().max().item()
        err = (b.cpu() - a).abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)


def test_train_cli_smoke_on_the_card(card):
    """`python -m repro_torch.launch.train --smoke` on the card: the verify
    recipe's drill (checkpoints, a node lost at step 20, degraded restore,
    rebuild), the loss going down, attention blockwise at head dim 16."""
    from repro_torch.launch import train

    fak.reset_counts()
    layers.reset_blockwise_calls()
    losses = train.run(["--smoke", "--steps", "30", "--batch", "2", "--seq",
                        "64", "--ckpt-every", "10", "--fail-node", "5",
                        "--fail-at", "20", "--log-every", "10"])
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert (fak.launches, fak.plain_calls) == (0, 0)
    assert layers.blockwise_calls == 30 * 2


def _vision_smoke(card, seed=0):
    """llama-vision SMOKE with its gates drawn from U(0.3, 0.9) (at init
    they are 0 and the cross-attention adds nothing) on the CPU and the
    same weights on the card."""
    from repro_torch.configs import get_config

    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    host = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    for block in host.blocks:
        if block.kind == "cross_attn":
            block.xattn.gate_attn.fill_(rng.uniform(0.3, 0.9))
            block.xattn.gate_ffn.fill_(rng.uniform(0.3, 0.9))
    return cfg, host, params_from_jax(cfg, params_to_tree(host), card)


def test_rwkv_scan_on_the_card_matches_the_cpu(card, monkeypatch):
    """The chunked WKV scan in fp32 on the card against the CPU, TF32
    off (a TF32 einsum would round each product to 10 mantissa bits):
    1e-5 of max |y| and max |state|, at the serve chunk (32) and a ragged
    one (23, S = 2047)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for S in (64, 2047):
        rng = np.random.default_rng(S)
        r, k, v = (torch.from_numpy(rng.normal(size=(2, S, 4, 64))
                                    .astype(np.float32)) for _ in range(3))
        w_log = -torch.from_numpy(np.exp(rng.normal(size=(2, S, 4, 64))
                                         - 1.0).astype(np.float32))
        u = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
        chunk = layers.rwkv_chunk(S)
        want = layers.rwkv_chunk_scan(r, k, v, w_log, u, chunk)
        got = layers.rwkv_chunk_scan(*(t.to(card) for t in
                                       (r, k, v, w_log, u)), chunk)
        for a, b in zip(want, got):
            assert b.device.type == "cuda" and b.dtype == torch.float32
            assert (b.cpu() - a).abs().max().item() <= \
                1e-5 * a.abs().max().item()


def test_rwkv_smoke_on_the_card_matches_the_cpu(card, monkeypatch):
    """rwkv6 SMOKE on the card against the same weights on the CPU, TF32
    off: train logits over 40 tokens, a prefill of 30 and 10 decode steps
    (the one-step recurrence writing the cache in place), within 5e-2 of
    max |logit|; no attention on either."""
    from repro_torch.configs import get_config

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("rwkv6-7b", smoke=True)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 40)))
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, _, _ = forward(dev, tokens.to(card), mode="train")
    want, _, _ = forward(host, tokens, mode="train")
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == (0, 0, 0)
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale
    _, cache, _ = forward(dev, tokens[:, :30].to(card), mode="prefill")
    assert cache[0][0]["state"].device.type == "cuda"
    for i in range(30, 40):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
        assert (step[:, 0].cpu().float() - want[:, i].float()).abs().max() \
            .item() < 5e-2 * scale


def test_vision_smoke_on_the_card_matches_the_cpu(card):
    """llama-vision SMOKE, gates open, on the card against the CPU: train
    logits with a stub vision input, a prefill of 20 and 4 decode steps
    (the vision keys and values read from the cache, unpadded), within
    5e-2 of max |logit|; head dim 16 attends blockwise on both."""
    cfg, host, dev = _vision_smoke(card)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 24)))
    vision = torch.from_numpy(rng.normal(size=(2, cfg.vision_seq,
                                               cfg.d_model))).bfloat16()
    got, _, _ = forward(dev, tokens.to(card), mode="train",
                        vision=vision.to(card))
    want, _, _ = forward(host, tokens, mode="train", vision=vision)
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale
    _, cache, _ = forward(dev, tokens[:, :20].to(card), mode="prefill",
                          vision=vision.to(card))
    cache = pad_cache_to(cache, cfg, 24)
    assert cache[0][4]["k"].shape[3] == cfg.vision_seq
    for i in range(20, 24):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
        assert (step[:, 0].cpu().float() - want[:, i].float()).abs().max() \
            .item() < 5e-2 * scale


def test_vision_cross_attention_at_head_dim_128_launches_the_kernel(card):
    """At head dim 128 the cross-attention layer launches the bf16 flash
    kernel, not causal, at prefill (Sq = S, Skv = vision_seq) and at
    decode (Sq = 1): one launch per call, and the card's logits are the
    CPU's (the kernel's plain version there) within 5e-2."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b", smoke=True),
                              name="llama-vision-hd128", head_dim=128,
                              vision_seq=300)
    host = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for block in host.blocks:
        if block.kind == "cross_attn":
            block.xattn.gate_attn.fill_(0.6)
            block.xattn.gate_ffn.fill_(0.4)
    dev = params_from_jax(cfg, params_to_tree(host), card)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 40)))
    vision = torch.from_numpy(rng.normal(size=(2, 300, cfg.d_model))
                              ).bfloat16()
    want, _, _ = forward(host, tokens, mode="prefill", vision=vision)
    fak.reset_counts()
    _, cache, _ = forward(dev, tokens[:, :39].to(card), mode="prefill",
                          vision=vision.to(card))
    assert (fak.launches, fak.plain_calls) == (5, 0)
    step, _, _ = forward(dev, tokens[:, 39:].to(card), mode="decode",
                         cache=pad_cache_to(cache, cfg, 44), pos=39)
    assert (fak.launches, fak.plain_calls) == (6, 0)
    scale = want.float().abs().max().item()
    assert (step[:, 0].cpu().float() - want[:, -1].float()).abs().max() \
        .item() < 5e-2 * scale


def test_hubert_smoke_on_the_card_matches_the_cpu(card):
    """hubert SMOKE (frame embeddings, not causal) encoded on the card
    against the CPU within 5e-2 of max |logit|, blockwise at head dim 16;
    its SMOKE train step runs on the card."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    cfg = get_config("hubert-xlarge", smoke=True)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    frames = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32))
    layers.reset_blockwise_calls()
    got, _, _ = forward(dev, frames.to(card))
    want, _, _ = forward(host, frames)
    assert layers.blockwise_calls == 2 * cfg.num_layers
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale
    state = init_train_state(cfg, torch.Generator(card).manual_seed(0), card)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           TrainConfig(accum=2, remat="block"))
    labels = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 64)))
    state, metrics = step(state, frames, labels)
    assert bool(torch.isfinite(metrics["loss"])) and int(state.step) == 1


def test_flash_operator_launches_the_kernel(card):
    """`torch.ops.repro_torch.flash_attention_fwd` on CUDA tensors is the
    kernel's launch: one launch counted, the plain version's result."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda").bfloat16()
               for sh in ((2, 8, 256, 128), (2, 2, 256, 128),
                          (2, 2, 256, 128)))
    fak.reset_counts()
    # repro-lint: allow=RA001
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, 0)
    assert fak.launches == 1 and fak.plain_calls == 0
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.float() - want.float()).abs().max().item() < 2e-2
    assert (lse - want_lse).abs().max().item() < 2e-2


def test_sharded_step_on_the_card_is_the_unsharded_step(card):
    """Two SMOKE steps (accum 2, remat, seq_parallel) on the card's host
    mesh, (data 1, model 1): losses and every leaf bit for bit those of
    the same steps without a mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import shard_state
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_to_tree)

    cfg = get_config("llama3.2-3b", smoke=True)
    mesh = make_host_mesh()

    def steps(m):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state = init_train_state(cfg, gen, "cuda")
        if m is not None:
            shard_state(state, m)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                               TrainConfig(accum=2, remat="block",
                                           seq_parallel=True), mesh=m)
        data = torch.Generator()
        data.manual_seed(1)
        losses = []
        for _ in range(2):
            t = torch.randint(0, cfg.vocab_size, (4, 32), generator=data)
            state, met = step(state, t, torch.roll(t, -1, 1))
            losses.append(float(met["loss"]))
        return losses, train_state_to_tree(state)

    def flat(tree, out):
        if isinstance(tree, dict):
            for v in tree.values():
                flat(v, out)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                flat(v, out)
        else:
            out.append(tree)
        return out
    want_losses, want = steps(None)
    got_losses, got = steps(mesh)
    assert got_losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(flat(want, []),
                                                 flat(got, [])))


# ---------------------------------------------------------------------------
# The launch planner: any grid the planner may choose is correct
# ---------------------------------------------------------------------------

def _delta_terms(card):
    """The delta-terms shape (21 x 1 over one 1 MiB stripe) on the card."""
    cols = torch.from_numpy(gf_bit_columns(
        _bytes(21, (21, 1)).numpy())).to(card)
    return cols, _bytes(22, (1, 1, 1 << 20)).to(card)


def test_every_candidate_grid_gives_the_same_bytes(card):
    """Each grid `measure_matmul_tiles` would time at the delta-terms
    shape, and grids below the SMs that a timings entry may name, launch
    and give the plain version's bytes."""
    from repro_torch.kernels import autotune
    cols, data = _delta_terms(card)
    sms = autotune.device_sms(card)
    want = gfk.gf_bitmatmul_plain(cols.cpu(), data.cpu())
    resident = gfk.resident_ctas(21, 1, card)
    grids = autotune.matmul_candidates(1, 21, 1 << 20, sms=sms,
                                       resident=resident)
    assert grids[0] == sms and len(grids) == resident
    for g in sorted({1, 2, 3, sms // 2, sms - 1, *grids}):
        before = gfk.launches
        got = gfk.gf_bitmatmul(cols, data, grid=g)  # repro-lint: allow=RA001
        torch.cuda.synchronize()
        assert gfk.launches == before + 1
        assert torch.equal(got.cpu(), want), g


@pytest.mark.parametrize("grid", [None, 1, 2, 131])
def test_host_plan_reports_the_asked_grid(card, grid):
    """`host_plan(..., grid=g)` is the launch the kernel would make: g
    itself, or the persistent default for None, with the plan's tiling
    and the CTAs an SM holds at once beside it (one: the kernel's 168
    registers a thread fill an SM's register file)."""
    from repro_torch.kernels import autotune
    sms = autotune.device_sms(card)
    plan = gfk.host_plan(1, 21, 1, 1 << 20, grid=grid)
    model = autotune.matmul_plan(1, 21, 1 << 20, sms=sms)
    assert plan["grid"] == (model.grid_steps if grid is None else grid)
    assert plan["smem"] == model.smem_bytes
    assert plan["resident"] == gfk.resident_ctas(21, 1, card) >= 1


def test_grid_beyond_the_sms_capacity_raises(card):
    """A grid past what the SMs hold at once (the occupancy calculator's
    count, registers included), or past the tiles, is refused by the host
    code (plan and launch alike) rather than launched as some other grid;
    the wrapper launches nothing."""
    from repro_torch.kernels import autotune
    cols, data = _delta_terms(card)
    sms = autotune.device_sms(card)
    over = sms * gfk.resident_ctas(21, 1, card) + 1
    before = gfk.launches
    with pytest.raises(RuntimeError, match="gf_plan"):
        gfk.host_plan(1, 21, 1, 1 << 20, grid=over)
    with pytest.raises(RuntimeError, match="gf_matmul"):
        gfk.gf_bitmatmul(cols, data, grid=over)  # repro-lint: allow=RA001
    # 4096 bytes are 32 tiles: a CTA more is refused, 32 launch
    small = data[:, :, :4096].contiguous()
    tiles = 4096 // 128
    with pytest.raises(RuntimeError, match="gf_plan"):
        gfk.host_plan(1, 21, 1, 4096, grid=tiles + 1)
    with pytest.raises(RuntimeError, match="gf_matmul"):
        gfk.gf_bitmatmul(cols, small, grid=tiles + 1)  # repro-lint: allow=RA001
    assert gfk.launches == before
    gfk.gf_bitmatmul(cols, small, grid=tiles)  # repro-lint: allow=RA001
    assert gfk.launches == before + 1
    blocks = _bytes(3, (2, 3, 4096)).to(card)
    with pytest.raises(RuntimeError, match="xor_fold"):
        # repro-lint: allow=RA008
        xrk.xor_reduce(blocks, grid=2)           # repro-lint: allow=RA001


@pytest.mark.parametrize("grid", [1, 2, 128, 256])
def test_every_xor_grid_width_gives_the_same_bytes(card, grid):
    """The XOR kernel at S=23, s=20, 1 MiB, from one block wide up to the
    blocks the bytes need, against the plain version."""
    blocks = _bytes(grid, (23, 20, 1 << 20))
    got = xrk.xor_reduce(blocks.to(card), grid=grid)  # repro-lint: allow=RA001
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), xrk.xor_reduce_plain(blocks))


def test_measured_plan_is_launched_through_ops(card, tmp_path, monkeypatch):
    """A measured entry in the timings file reaches the launch: `ops`
    plans it (source "measured"), the host code reports that grid, and
    the bytes stay the plain version's."""
    from repro_torch.kernels import autotune, ops
    sms = autotune.device_sms(card)
    path = tmp_path / "timings.json"
    autotune.save_timings({autotune.matmul_key(1, 21, 1 << 20):
                           {"grid_steps": sms // 2}}, path)
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.invalidate_plan_cache()
    try:
        M = _bytes(21, (21, 1)).numpy()
        plan = autotune.plan_matmul_tiles(
            1, 21, 1 << 20, sms=sms, resident=gfk.resident_ctas(21, 1, card))
        assert (plan.source, plan.grid_steps) == ("measured", sms // 2)
        assert gfk.host_plan(1, 21, 1, 1 << 20,
                             grid=plan.grid_steps)["grid"] == sms // 2
        data = _bytes(22, (1, 1 << 20))
        got = ops.apply_matrix(M, data.to(card))
        torch.cuda.synchronize()
        want = gfk.gf_bitmatmul_plain(
            torch.from_numpy(gf_bit_columns(M)), data[None])[0]
        assert torch.equal(got.cpu(), want)
    finally:
        monkeypatch.delenv(autotune.CACHE_ENV)
        autotune.invalidate_plan_cache()
