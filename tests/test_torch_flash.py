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
# hubert's 80 and kimi's 112 have no flash kernel; 64 has one; 256 is a
# multiple of 128, which the reference hands its Pallas kernel
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
