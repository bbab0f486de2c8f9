"""The port's flash-attention forward against the reference's Pallas
kernel (interpret mode) on the CPU.

The same inputs, made with numpy from a seed, go through
`repro.kernels.flash_attention.flash_attention_fwd(..., interpret=True)`
and the port's wrapper on CPU tensors, which runs the plain version of the
kernel's block loop. Tolerances: 2e-5 in fp32 (the two run the same
arithmetic in another summation order) and 2e-2 in bf16 (one bf16
rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as ref_fwd
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels.ref import flash_attention_ref

# the reference's FLASH_CASES (tests/test_kernels.py)
# causal, window, B, Hq, Hkv, Sq, Skv, dk, dv, bq, bk, dtype
FLASH_CASES = [
    (True, 0, 1, 2, 1, 256, 256, 128, 128, 128, 128, "float32"),
    (True, 0, 2, 4, 2, 256, 256, 128, 128, 64, 128, "bfloat16"),
    (False, 0, 1, 2, 2, 128, 256, 128, 128, 128, 64, "float32"),
    (True, 128, 1, 2, 1, 512, 512, 128, 128, 128, 128, "float32"),
    # head dim 256 (recurrentgemma's local attention: MQA, windowed)
    (True, 96, 1, 4, 1, 256, 256, 256, 256, 128, 128, "bfloat16"),
    (True, 96, 1, 4, 1, 256, 256, 256, 256, 128, 128, "float32"),
]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, Hq, Hkv, Sq, Skv, dk, dv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, Hq, Sq, dk)), rng.normal(size=(B, Hkv, Skv, dk)),
            rng.normal(size=(B, Hkv, Skv, dv)))
    ref = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    port = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(_TORCH[dtype])
            for r in ref]
    return ref, port


def test_plain_calls_count_in_no_launch_mode():
    """`mode_launches` counts kernel launches only: a CPU call, here a
    decode-shaped one (Sq = 1, not causal), adds to `plain_calls`."""
    fak.reset_counts()
    fak.flash_attention_fwd(*(torch.randn(1, 2, S, 64) for S in (1, 8, 8)),
                            causal=False)
    assert (fak.mode_launches, fak.launches, fak.plain_calls) == ({}, 0, 1)


@pytest.mark.parametrize(
    "causal,window,B,Hq,Hkv,Sq,Skv,dk,dv,bq,bk,dtype", FLASH_CASES)
def test_plain_matches_pallas_interpret(causal, window, B, Hq, Hkv, Sq, Skv,
                                        dk, dv, bq, bk, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(B, Hq, Hkv, Sq, Skv, dk, dv, dtype)
    want, want_lse = ref_fwd(q, k, v, causal=causal, window=window,
                             block_q=bq, block_k=bk, interpret=True)
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(tq, tk, tv, causal=causal,
                                       window=window, block_q=bq, block_k=bk)
    assert (fak.launches, fak.plain_calls) == (0, 1)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=tol, atol=tol)


# shapes the Pallas kernel does not take: ragged blocks, Sq != Skv with
# causal masking, a window wider than a block, one token
@pytest.mark.parametrize("causal,window,Sq,Skv,bq,bk", [
    (True, 0, 100, 100, 64, 64),
    (False, 0, 37, 333, 16, 64),
    (True, 0, 50, 70, 32, 32),
    (True, 40, 200, 200, 64, 32),
    (False, 24, 90, 90, 512, 512),
    (True, 0, 1, 1, 512, 512),
])
def test_plain_matches_naive_softmax(causal, window, Sq, Skv, bq, bk):
    _, (q, k, v) = _inputs(2, 4, 2, Sq, Skv, 64, 64, "float32", seed=Sq)
    out, lse = fak.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       block_q=bq, block_k=bk)
    want = flash_attention_ref(q, k, v, causal, window)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1))
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    s = torch.where(mask, s * 64 ** -0.5, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                               rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_get_minus_inf_lse():
    # non-causal window past the keys: rows 0..(Sq - Skv - window) see none
    _, (q, k, v) = _inputs(1, 2, 1, 40, 8, 64, 64, "float32")
    out, lse = fak.flash_attention_fwd(q, k, v, causal=False, window=4)
    dead = torch.arange(40) - 7 >= 4
    assert torch.isneginf(lse[..., dead]).all()
    assert (out[..., dead, :] == 0).all()
    assert torch.isfinite(lse[..., ~dead]).all()


def test_bounds_count_the_unmasked_pairs():
    assert fak.unmasked_pairs(4, 4, True, 0) == 10
    assert fak.unmasked_pairs(4, 6, False, 0) == 24
    assert fak.unmasked_pairs(5, 5, True, 2) == 9
    # the serving prefill: B=4, Hq=32, S=2048, d=128, causal
    flops = fak.bound_flops(4, 32, 2048, 2048, 128, 128, causal=True)
    assert flops == 4 * 32 * (2048 * 2049 // 2) * 4 * 128
    assert fak.bound_bytes(4, 32, 8, 2048, 2048, 128, 128, 2) == (
        2 * (4 * 32 * 2048 * 256 + 4 * 8 * 2048 * 256) + 4 * 4 * 32 * 2048)
    # recurrentgemma's prefill: B=2, Hq=16, Hkv=1, S=3968, d=256, causal,
    # window 2048: 197.6 GFLOP over the pairs the window keeps
    pairs = 2048 * 2049 // 2 + (3968 - 2048) * 2048
    assert fak.unmasked_pairs(3968, 3968, True, 2048) == pairs
    assert fak.bound_flops(2, 16, 3968, 3968, 256, 256, causal=True,
                           window=2048) == 2 * 16 * pairs * 4 * 256 \
        == 197_602_050_048


def test_wrapper_rejects_what_it_cannot_take():
    _, (q, k, v) = _inputs(1, 3, 2, 8, 8, 64, 64, "float32")
    with pytest.raises(ValueError):                  # Hq % Hkv != 0
        fak.flash_attention_fwd(q, k, v)
    _, (q, k, v) = _inputs(1, 2, 1, 8, 8, 64, 64, "float32")
    with pytest.raises(TypeError):
        fak.flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        fak.flash_attention_fwd(q, k, v, window=-1)
    with pytest.raises(ValueError):
        fak.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


# causal, window, B, Hq, Hkv, Sq, Skv, head dim: the SMOKE configs' 16,
# hubert's 80 and kimi's 112 have no flash kernel; 64 has one; 256
# (recurrentgemma) has one and is a multiple of 128, which the reference
# hands its Pallas kernel
ROUTE_CASES = [
    (True, 0, 2, 6, 2, 24, 24, 16), (True, 0, 1, 4, 2, 1500, 1500, 16),
    (False, 0, 1, 2, 1, 40, 90, 80), (True, 7, 1, 4, 4, 33, 33, 112),
    (True, 0, 1, 2, 1, 48, 48, 64), (True, 5, 1, 2, 1, 40, 40, 256),
]


@pytest.mark.parametrize("causal,window,B,Hq,Hkv,Sq,Skv,d", ROUTE_CASES)
def test_layer_routes_head_dims_without_a_kernel_blockwise(
        causal, window, B, Hq, Hkv, Sq, Skv, d):
    """`layers.flash_attention` sends head dims outside `HEAD_DIMS` that are
    not multiples of 128 to the blockwise forward (never to the wrapper,
    which would raise for them on the card) and the others to the wrapper,
    as the reference's `_flash_fn` routes; both agree with the reference's
    layer in bf16 within 2e-2."""
    from repro.models.layers import flash_attention as ref_layer
    from repro_torch.models import layers

    (q, k, v), (tq, tk, tv) = _inputs(B, Hq, Hkv, Sq, Skv, d, d, "bfloat16",
                                      seed=d)
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = layers.flash_attention(tq, tk, tv, causal=causal, window=window)
    kernel = (d, d) in fak.HEAD_DIMS or d % 128 == 0
    assert (fak.plain_calls, layers.blockwise_calls) == \
        ((1, 0) if kernel else (0, 1))
    assert fak.launches == 0 and out.shape == (B, Hq, Sq, d)
    want = ref_layer(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# The fp32 CUDA kernel multiplies on the tensor cores in TF32 (10 stored
# mantissa bits) with each operand split into a TF32 high part and a TF32
# low part: hi*hi + hi*lo + lo*hi in fp32, lo*lo dropped. Below, that
# arithmetic is emulated on the CPU (round-to-nearest TF32 by bit masking;
# a product of two TF32 values is exact in fp32, so an fp32 matmul of TF32
# operands is what the tensor core sums) inside the kernel's loop over
# 32-key tiles, and held to the reference's Pallas kernel.
NEG_INF = fak.NEG_INF


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest TF32 value, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def _one_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _tf32_flash(q, k, v, causal, window, product, block_k=32):
    """The fp32 kernel's loop: 32-key tiles, running max and sum, both
    products through `product`, the Pallas kernel's masking rules."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(Hq // Hkv, dim=1)
    vf = v.repeat_interleave(Hq // Hkv, dim=1)
    m = torch.full((B, Hq, Sq), NEG_INF)
    l = torch.zeros((B, Hq, Sq))
    acc = torch.zeros((B, Hq, Sq, d))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = product(q, kb.transpose(-1, -2)) * d ** -0.5
        kpos = k0 + torch.arange(kb.shape[2])[None]
        keep = torch.ones((Sq, kb.shape[2]), dtype=torch.bool)
        if causal:
            keep &= qpos >= kpos
        if window:
            keep &= qpos - kpos < window
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m_new[..., None]))
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + product(p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), -torch.inf)
    return out, lse


# causal, window, Hq, Hkv, S, d, scale of q
TF32_CASES = [
    (True, 0, 2, 1, 256, 64, 1.0),
    (True, 0, 2, 1, 256, 128, 1.0),
    (True, 96, 4, 1, 256, 256, 1.0),
    (True, 0, 2, 1, 256, 128, 8.0),      # scores in the tens (up to 39)
]


def _tf32_errors(causal, window, Hq, Hkv, S, d, scale, product):
    (q, k, v), (tq, tk, tv) = _inputs(1, Hq, Hkv, S, S, d, d, "float32",
                                      seed=d)
    want, want_lse = ref_fwd(q * scale, k, v, causal=causal, window=window,
                             block_q=128, block_k=128, interpret=True)
    out, lse = _tf32_flash(tq * scale, tk, tv, causal, window, product)
    want = torch.from_numpy(np.array(want, np.float32))
    want_lse = torch.from_numpy(np.array(want_lse, np.float32))
    return ((out - want).abs().max().item(),
            (lse - want_lse).abs().max().item())


@pytest.mark.parametrize("causal,window,Hq,Hkv,S,d,scale", TF32_CASES)
def test_3xtf32_split_holds_the_fp32_tolerances(causal, window, Hq, Hkv, S,
                                                d, scale):
    err, lse_err = _tf32_errors(causal, window, Hq, Hkv, S, d, scale,
                                _split_product)
    assert err <= 2e-5 and lse_err <= 1e-4, (err, lse_err)


@pytest.mark.parametrize("causal,window,Hq,Hkv,S,d,scale", TF32_CASES)
def test_one_tf32_product_misses_the_fp32_tolerances(causal, window, Hq, Hkv,
                                                     S, d, scale):
    """Why the kernel needs the split: one TF32 product per product (what
    the tensor cores give fp32 inputs unsplit) misses 2e-5 / 1e-4."""
    err, lse_err = _tf32_errors(causal, window, Hq, Hkv, S, d, scale,
                                _one_product)
    assert err > 2e-5 or lse_err > 1e-4, (err, lse_err)


def test_tf32_rounding_is_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0e38, -7.5e-30],
                     dtype=torch.float32)
    got = _tf32(x)
    # ties go away from zero; 10 stored mantissa bits remain
    assert got.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -10)]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.allclose(got, x, rtol=2.0 ** -11, atol=0)


def test_3xtf32_split_error_grows_with_the_scores():
    """The split's limit, stated: with q and k scaled by 8 (scores in the
    hundreds) the dropped lo*lo term and lo's rounding show, and the split
    misses 2e-5 on out where the plain fp32 version stays within it. The
    kernel's tolerances hold for scores in the tens (TF32_CASES)."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 2, 1, 256, 256, 128, 128,
                                      "float32", seed=128)
    want, _ = ref_fwd(q * 8, k * 8, v, causal=True, block_q=128,
                      block_k=128, interpret=True)
    want = torch.from_numpy(np.array(want, np.float32))
    split, _ = _tf32_flash(tq * 8, tk * 8, tv, True, 0, _split_product)
    plain, _ = fak.flash_attention_fwd(tq * 8, tk * 8, tv)
    assert (split - want).abs().max().item() > 2e-5
    assert (plain - want).abs().max().item() <= 2e-5
