"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Byte equality for the coding kernels (GF(2^8) coding is exact);
attention within 2e-2 in bf16 and 2e-5 (out) / 1e-4 (lse) in fp32.

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
from repro_torch.models import (ModelConfig, forward, init_params,
                                pad_cache_to, params_from_jax, params_to_tree,
                                uniform_segments)

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
    gfk.gf_bitmatmul(cols, data)                       # built and warm
    torch.cuda.synchronize()
    before = (gfk.launches, gfk.plain_calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gfk.gf_bitmatmul(cols, data)
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
    got = gfk.gf_bitmatmul(cols.to(card), flat.to(card)[1:].view(2, k, 2048))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gfk.gf_bitmatmul_plain(cols, view))


@pytest.mark.parametrize("S,s,B", [(1, 1, 5), (1, 2, 3000), (23, 20, 65536),
                                   (4, 29, 4097)])
def test_xor_matches_plain(card, S, s, B):
    blocks = _bytes(s * B, (S, s, B))
    got = xrk.xor_reduce(blocks.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), xrk.xor_reduce_plain(blocks))


def test_wrappers_count_launches_only_on_the_card(card):
    gfk.reset_counts()
    xrk.reset_counts()
    x = _bytes(0, (1, 3, 64)).to(card)
    xrk.xor_reduce(x)
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


def test_flash_head_dim_outside_the_kernel_raises(card):
    q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, 64, 64, 96,
                                        torch.bfloat16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fak.flash_attention_fwd(q, k, v)


def test_flash_counts_launches_only_on_the_card(card):
    fak.reset_counts()
    q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, 64, 64, 64,
                                        torch.bfloat16))
    fak.flash_attention_fwd(q, k, v)
    assert (fak.launches, fak.plain_calls) == (1, 0)


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
