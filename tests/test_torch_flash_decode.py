"""The port's split-KV decode path (`flash_decode_plain`, the plain version
of `csrc/flash_decode_sm90.cu`) against the reference's Pallas kernel
(interpret mode) on the CPU, and the wrapper's route to it.

The same inputs, made with numpy from a seed, go through
`repro.kernels.flash_attention.flash_attention_fwd(..., interpret=True)`
and `flash_decode_plain` at 1, 3 and more key slices than keys (empty
slices). Tolerances: fp32 inputs 1e-5 on out and lse (the same arithmetic
summed in another order); bf16 inputs 1e-3 on lse and 2e-3 on out beyond
one bf16 rounding of it (rtol = bf16's eps, 2^-7: at Skv 1 to 300 |out|
reaches ~2, where the two packages' fp32 sums can round to neighbouring
bf16 values). A row that sees no key gives out 0 and lse -inf in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as ref_fwd
from repro_torch.kernels import flash_attention as fak
from repro_torch.models import layers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# mask name -> (causal, window)
MASKS = {"none": (False, 0), "causal": (True, 0), "window": (True, 2)}
B, HKV = 2, 2

# Sq, G, d, Skv, mask, dtype
DECODE_CASES = (
    # every mask at every Sq (G = 4, d = 128, Skv = 48)
    [(Sq, 4, 128, 48, m, "bfloat16") for Sq in (1, 2, 4) for m in MASKS]
    # every G at every head dim (Sq = 1, Skv = 300, not causal)
    + [(1, G, d, 300, "none", "bfloat16") for G in (1, 4, 16)
       for d in (64, 128, 256)]
    # every Skv under every mask (Sq = 2, G = 4, d = 64)
    + [(2, 4, 64, Skv, m, "bfloat16") for Skv in (1, 7, 48, 300)
       for m in MASKS]
    # fp32 inputs
    + [(1, 16, 64, 300, "none", "float32"), (4, 4, 64, 7, "window", "float32"),
       (2, 1, 128, 48, "causal", "float32"),
       (4, 4, 256, 300, "causal", "float32")]
    # G x Sq at the cap, windowed at head dim 256; rows that see no key
    # (the window past Skv = 1 and 2)
    + [(4, 4, 256, 300, "window", "bfloat16"),
       (4, 4, 64, 1, "window", "bfloat16"),
       (4, 4, 128, 2, "window", "float32")]
)


def _inputs(Sq, G, d, Skv, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, HKV * G, Sq, d)),
            rng.normal(size=(B, HKV, Skv, d)),
            rng.normal(size=(B, HKV, Skv, d)))
    ref = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    port = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(_TORCH[dtype])
            for r in ref]
    return ref, port


@pytest.mark.parametrize("Sq,G,d,Skv,mask,dtype", DECODE_CASES)
def test_decode_plain_matches_pallas_interpret(Sq, G, d, Skv, mask, dtype):
    causal, window = MASKS[mask]
    (q, k, v), (tq, tk, tv) = _inputs(Sq, G, d, Skv, dtype,
                                      seed=Sq * 1000 + Skv + G)
    want, want_lse = ref_fwd(q, k, v, causal=causal, window=window,
                             interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(want_lse)
    dead = np.isneginf(want_lse)
    if mask == "window" and Sq - MASKS["window"][1] >= Skv:
        assert dead.any()                   # the last row sees no key
    rtol, atol, lse_tol = ((torch.finfo(torch.bfloat16).eps, 2e-3, 1e-3)
                           if dtype == "bfloat16" else (1e-5, 1e-5, 1e-5))
    for n_split in (1, 3, Skv + 5):         # the last: empty slices
        out, lse = fak.flash_decode_plain(tq, tk, tv, causal=causal,
                                          window=window, n_split=n_split)
        assert out.dtype == tq.dtype and lse.dtype == torch.float32
        np.testing.assert_allclose(out.float().numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=f"n_split={n_split}")
        assert np.array_equal(np.isneginf(lse.numpy()), dead)
        np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead],
                                   rtol=lse_tol, atol=lse_tol,
                                   err_msg=f"n_split={n_split}")
        assert (out.float().numpy()[dead] == 0).all()
        assert (want[dead] == 0).all()


@pytest.mark.parametrize("bh,skv,sms", [
    (32, 6404, 132), (1, 1, 132), (2, 300, 132), (1, 32768, 132),
    (64, 6404, 132), (512, 6404, 132), (32, 6404, 114), (8, 127, 132)])
def test_decode_splits_fill_the_card_with_whole_tiles(bh, skv, sms):
    """Slices are whole `DECODE_BK`-key tiles (the last ends at Skv), none
    is empty, and the grid fits one CTA an SM in one wave where the keys
    allow; at the vision decode: 4 slices of 1,664 keys."""
    n = fak.decode_splits(bh, skv, sms)
    n_tiles = -(-skv // fak.DECODE_BK)
    per = -(-n_tiles // n)
    assert 1 <= n <= n_tiles
    assert (n - 1) * per < n_tiles <= n * per        # no empty slice
    assert bh * n <= max(bh, sms)
    if (bh, skv, sms) == (32, 6404, 132):
        assert (n, per * fak.DECODE_BK) == (4, 1664)


# G, Sq, dtype, route
ROUTES = [(4, 4, "bfloat16", "decode"),     # at the cap: 16 rows
          (4, 5, "bfloat16", "prefill"),    # one row group past it
          (16, 1, "bfloat16", "decode"),    # recurrentgemma's MQA, one token
          (1, 16, "bfloat16", "decode"),
          (1, 17, "bfloat16", "prefill"),
          (4, 1, "float32", "prefill")]     # fp32 keeps the prefill path


@pytest.mark.parametrize("G,Sq,dtype,route", ROUTES)
def test_wrapper_routes_few_rows_to_the_decode_path(monkeypatch, G, Sq,
                                                    dtype, route):
    """On the CPU, bf16 with G x Sq <= DECODE_ROWS takes
    `flash_decode_plain` at `decode_splits(B x Hkv, Skv, H100_SMS)` and
    every other call `flash_attention_fwd_plain`; each is one plain call
    and no launch."""
    taken = []
    decode, prefill = fak.flash_decode_plain, fak.flash_attention_fwd_plain

    def spy_decode(*a, **kw):
        taken.append(("decode", kw["n_split"]))
        return decode(*a, **kw)

    def spy_prefill(*a, **kw):
        taken.append(("prefill", None))
        return prefill(*a, **kw)
    monkeypatch.setattr(fak, "flash_decode_plain", spy_decode)
    monkeypatch.setattr(fak, "flash_attention_fwd_plain", spy_prefill)
    _, (q, k, v) = _inputs(Sq, G, 64, 300, dtype, seed=7)
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v, causal=False)
    assert fak.is_decode(q, k) == (route == "decode")
    want = fak.decode_splits(B * HKV, 300, fak.H100_SMS) \
        if route == "decode" else None
    assert taken == [(route, want)]
    assert (fak.plain_calls, fak.launches, fak.decode_launches,
            fak.mode_launches) == (1, 0, 0, {})
    assert out.shape == (B, HKV * G, Sq, 64) and lse.shape == (B, HKV * G, Sq)


def test_cross_attention_layer_decode_takes_the_decode_path(monkeypatch):
    """`layers.flash_attention` has no branch of its own: a cross-attention
    decode call (bf16, Sq = 1, the vision model's 32 / 8 heads at head dim
    128, not causal) reaches the wrapper, which takes the decode path; its
    result is the prefill plain version's within the bf16 bounds."""
    taken = []
    decode = fak.flash_decode_plain

    def spy(*a, **kw):
        taken.append(kw["n_split"])
        return decode(*a, **kw)
    monkeypatch.setattr(fak, "flash_decode_plain", spy)
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               .bfloat16() for sh in ((1, 32, 1, 128), (1, 8, 300, 128),
                                      (1, 8, 300, 128)))
    fak.reset_counts()
    out = layers.flash_attention(q, k, v, causal=False)
    assert taken == [fak.decode_splits(8, 300, fak.H100_SMS)]
    assert fak.plain_calls == 1
    want, _ = fak.flash_attention_fwd_plain(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), want.float(),
                               rtol=torch.finfo(torch.bfloat16).eps,
                               atol=2e-3)
