"""The port's recurrent and local-attention pieces against the reference,
on the CPU: the Griffin RG-LRU block (`rg_block`), its log-depth scan, the
rotating window cache of local attention (`_roll_tail`, `_decode_window`)
and `pad_cache_to` on recurrentgemma's caches.

The reference's weights and inputs (numpy, from a seed) go into both
packages. Tolerances: 2e-2 of the reference's max |out| for the bf16 block
(bf16 matmuls round in other places in the two frameworks; measured
2.4e-5 when this test was written), 1e-5 relative for the fp32 scan
against a sequential fp64 recurrence, exact for the cache layouts (pure
data movement).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models.model import init_cache as ref_init_cache
from repro.models.model import pad_cache_to as ref_pad_cache_to
from repro_torch.configs import get_config
from repro_torch.models import init_cache, layers, pad_cache_to

TOL = 2e-2


def _rg_pair(seed=1):
    """The reference's `init_rg` weights, and the port's `RG` holding them."""
    ref_cfg = ref_get_config("recurrentgemma-9b", smoke=True)
    cfg = get_config("recurrentgemma-9b", smoke=True)
    params = RL.init_rg(jax.random.PRNGKey(seed), ref_cfg)
    rg = layers.RG(cfg, device="cpu")
    for name, leaf in params.items():
        dst = getattr(rg, name)
        assert tuple(dst.shape) == leaf.shape
        assert str(dst.dtype).replace("torch.", "") == str(leaf.dtype)
        dst.data.copy_(torch.from_numpy(
            np.array(leaf.astype(jnp.float32))).to(dst.dtype))
    return ref_cfg, params, rg


def _ctx(cfg, mode, pos=None):
    return RL.Ctx(cfg=cfg, mode=mode, pos=pos, vision=None,
                  attn_schedule=RL.DEFAULT_ATTN_SCHEDULE, mesh=None,
                  seq_parallel=False)


def _bf16(arr):
    """(reference bf16 array, port bf16 tensor) of the same values."""
    ref = jnp.asarray(arr, jnp.bfloat16)
    return ref, torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.float().numpy()).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("S", [1, 2, 5, 24])
def test_rg_block_train_and_prefill_match(S):
    ref_cfg, params, rg = _rg_pair()
    rng = np.random.default_rng(S)
    x, tx = _bf16(rng.normal(size=(2, S, ref_cfg.d_model)))
    want, _ = RL.rg_block(params, x, _ctx(ref_cfg, "train"), None)
    got, cache = layers.rg_block(rg, tx, "train", None)
    assert cache is None and got.dtype == torch.bfloat16
    assert _rel(want, got) < TOL
    want, ref_cache = RL.rg_block(params, x, _ctx(ref_cfg, "prefill"), None)
    got, cache = layers.rg_block(rg, tx, "prefill", None)
    assert _rel(want, got) < TOL
    assert cache.keys() == ref_cache.keys()
    for name in ("state", "conv"):
        a, b = np.asarray(ref_cache[name].astype(jnp.float32)), cache[name]
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).replace("torch.", "") == str(ref_cache[name].dtype)
        assert np.abs(a - b.float().numpy()).max() <= TOL * np.abs(a).max()


def test_rg_block_decode_matches_and_writes_the_cache_in_place():
    """Prefill 7 tokens, then decode 3 one at a time: each step's output
    and the new state / conv history agree with the reference's, and the
    port's step writes them into the cache tensors it was given."""
    ref_cfg, params, rg = _rg_pair(seed=2)
    rng = np.random.default_rng(7)
    x, tx = _bf16(rng.normal(size=(2, 10, ref_cfg.d_model)))
    _, rc = RL.rg_block(params, x[:, :7], _ctx(ref_cfg, "prefill"), None)
    _, pc = layers.rg_block(rg, tx[:, :7], "prefill", None)
    cache = {name: t.clone() for name, t in pc.items()}
    for i in range(7, 10):
        want, rc = RL.rg_block(params, x[:, i:i + 1],
                               _ctx(ref_cfg, "decode", jnp.int32(i)), rc)
        state, conv = cache["state"], cache["conv"]
        got, new = layers.rg_block(rg, tx[:, i:i + 1], "decode", cache)
        assert new["state"] is state and new["conv"] is conv
        assert _rel(want, got) < TOL
        assert _rel(rc["state"], state) < TOL
        assert _rel(rc["conv"].astype(jnp.float32), conv) < TOL
    # the decoded state is the prefill's of all 10 tokens: the port's
    # decode step computes the conv as the prefill does (the same bf16
    # adds in order), so the conv history is equal and the fp32 state
    # differs only by the scan's summation order
    _, full = layers.rg_block(rg, tx, "prefill", None)
    assert torch.equal(cache["conv"], full["conv"])
    torch.testing.assert_close(cache["state"], full["state"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 3, 7, 64, 100, 3968])
def test_scan_matches_a_sequential_fp64_recurrence(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(2, S, 8))
    b = rng.normal(size=(2, S, 8))
    prod, h = layers.linear_scan(torch.from_numpy(a).float(),
                                 torch.from_numpy(b).float())
    want_h, want_p = np.zeros_like(b), np.zeros_like(a)
    state, acc = np.zeros((2, 8)), np.ones((2, 8))
    for t in range(S):
        state = a[:, t] * state + b[:, t]
        acc = acc * a[:, t]
        want_h[:, t], want_p[:, t] = state, acc
    np.testing.assert_allclose(h.double().numpy(), want_h, rtol=1e-5,
                               atol=1e-5 * np.abs(want_h).max())
    np.testing.assert_allclose(prod.double().numpy(), want_p, rtol=1e-5,
                               atol=1e-30)


def test_scan_runs_the_references_order():
    """Same fp32 inputs: the port's recursion and the reference's
    `associative_scan` give the same bits (the same products and sums in
    the same order)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, size=(2, 77, 16)).astype(np.float32)
    b = rng.normal(size=(2, 77, 16)).astype(np.float32)

    def combine(x1, x2):
        return x1[0] * x2[0], x2[0] * x1[1] + x2[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    _, got = layers.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), np.asarray(want))


# S, window: shorter than the window, equal, longer with a non-zero
# shift ((S - keep) % window = 4) and longer by a whole window (shift 0)
WINDOWS = [(5, 8), (8, 8), (12, 8), (16, 8), (3968, 2048)]


@pytest.mark.parametrize("S,window", WINDOWS)
def test_roll_tail_matches_reference(S, window):
    kv = np.random.default_rng(S).normal(size=(1, 2, S, 4)).astype(np.float32)
    keep = min(window, S)
    want = RL._roll_tail(jnp.asarray(kv), keep, window)
    got = layers._roll_tail(torch.from_numpy(kv), keep, window)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # position p sits in slot p % window
    for p in range(S - keep, S):
        assert np.array_equal(got[:, :, p % window].numpy(), kv[:, :, p])


@pytest.mark.parametrize("S,window", WINDOWS[:4])
def test_decode_window_matches_reference(S, window):
    """A decode step at position pos = S against the window cache of the
    S tokens before it, rolled, with the new token written at pos %
    window: both packages compare slots by age."""
    rng = np.random.default_rng(S + window)
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    k = rng.normal(size=(2, 1, S + 1, 16)).astype(np.float32)
    v = rng.normal(size=(2, 1, S + 1, 16)).astype(np.float32)
    keep = min(window, S)
    kc = np.array(RL._roll_tail(jnp.asarray(k[:, :, :S]), keep, window))
    vc = np.array(RL._roll_tail(jnp.asarray(v[:, :, :S]), keep, window))
    kc[:, :, S % window] = k[:, :, S]
    vc[:, :, S % window] = v[:, :, S]
    want = RL._decode_window(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.int32(S), window)
    got = layers._decode_window(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), S, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and it is attention over the last `window` positions
    lo = max(0, S - window + 1)
    s = np.einsum("bhqd,bkd->bhqk", q, k[:, 0, lo:S + 1]) * 16 ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        got.numpy(), np.einsum("bhqk,bkd->bhqd", p, v[:, 0, lo:S + 1]),
        rtol=1e-5, atol=1e-5)


def test_pad_cache_to_leaves_rg_state_and_window_caches_alone():
    """recurrentgemma's caches are fixed-size: window caches (at most the
    window long) and recurrent states keep their shapes, as in the
    reference, whatever S_max asks for."""
    ref_cfg = ref_get_config("recurrentgemma-9b", smoke=True)
    cfg = get_config("recurrentgemma-9b", smoke=True)
    for S_max in (5, 8, 40):
        cache = init_cache(cfg, 2, S_max, device="cpu")
        padded = pad_cache_to(cache, cfg, S_max + 16)
        want = ref_pad_cache_to(ref_init_cache(ref_cfg, 2, S_max), ref_cfg,
                                S_max + 16)
        got = jax.tree_util.tree_leaves_with_path(padded)
        ref = jax.tree_util.tree_leaves_with_path(want)
        assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
                for p, a in ref] == [
            (jax.tree_util.keystr(p), tuple(b.shape),
             str(b.dtype).replace("torch.", "")) for p, b in got]
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(cache),
                                  got):
            assert b is a                       # not copied either
