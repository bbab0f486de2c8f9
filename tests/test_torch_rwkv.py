"""The port's RWKV6 blocks (`rwkv`, rwkv6-7b) against the reference, on the
CPU: the chunked WKV scan, the time-mix and channel-mix blocks in train,
prefill and decode mode, their gradients, the SMOKE model, trees and
checkpoints.

The reference's weights (`init_rwkv`, `init_rwkv_channel`, `init_params`
with a PRNGKey) go into the port; the same inputs (numpy, from a seed) go
through both. Tolerances:

- `rwkv_chunk_scan` against the reference's `_rwkv_chunk_scan` on the same
  fp32 inputs: 1e-5 of max |y| and of max |state| (the same products and
  sums; cumsum and einsum may add in another order), and against a
  per-step fp64 recurrence: 2e-4, the reference's own test bound;
- the bf16 blocks' outputs and caches: 2e-2 of max |out| (bf16 matmuls
  round in other places in the two frameworks);
- the blocks' gradients in fp32, against the reference's VJP: 1e-4 of
  each gradient's max |value|;
- the SMOKE model's logits (train, prefill, decode steps): 5e-2 of max
  |logit|, the bound `tests/test_archs.py` holds decode against train
  with;
- trees and checkpoints: byte for byte (the fp32 `decay_base` and `bonus`
  leaves beside the bf16 ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefManager
from repro.ckpt.store import BlockStore as RefStore
from repro.configs import get_config as ref_get_config
from repro.core import make_unilrc as ref_make_unilrc
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import pad_cache_to as ref_pad_cache_to
from repro.topo import Topology as RefTopology
from repro_torch.ckpt import BlockStore, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import make_unilrc
from repro_torch.io import TorchBackend
from repro_torch.models import (abstract_params, forward, init_cache,
                                layers, pad_cache_to, params_from_jax,
                                params_to_tree)
from repro_torch.models.model import _block_cache_spec
from repro_torch.topo import Topology

ARCH = "rwkv6-7b"
SCAN_TOL = 1e-5
BLOCK_TOL = 2e-2
GRAD_TOL = 1e-4
TOL = 5e-2


def _host(tree):
    """A reference tree as numpy, bf16 leaves as uint16 bit views."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), tree)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _rel(want, got) -> float:
    want, got = _np(want), _np(got)
    scale = float(np.abs(want).max())
    return float(np.abs(want - got).max()) / (scale if scale else 1.0)


def _ctx(cfg, mode, pos=None):
    return RL.Ctx(cfg=cfg, mode=mode, pos=pos, vision=None,
                  attn_schedule=RL.DEFAULT_ATTN_SCHEDULE, mesh=None,
                  seq_parallel=False)


def _load(module, params):
    """Copy a reference block's leaves into the port's module."""
    for name, leaf in params.items():
        dst = getattr(module, name)
        assert tuple(dst.shape) == leaf.shape, name
        assert str(dst.dtype).replace("torch.", "") == str(leaf.dtype), name
        dst.data.copy_(torch.from_numpy(_np(leaf)).to(dst.dtype))
    return module


def _blocks(seed=1):
    """(reference cfg, time-mix params, channel-mix params) and the port's
    `RWKV` and `RWKVChannel` holding them. The reference draws `decay_base`
    and `bonus` so that the decay varies across channels."""
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tp = RL.init_rwkv(k1, ref_cfg)
    cp = RL.init_rwkv_channel(k2, ref_cfg)
    return (ref_cfg, tp, cp, _load(layers.RWKV(cfg, device="cpu"), tp),
            _load(layers.RWKVChannel(cfg, device="cpu"), cp))


def _scan_inputs(S, seed=0, B=2, H=2, hd=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w_log = -np.exp(rng.normal(size=(B, S, H, hd)) - 1.0).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    return r, k, v, w_log, u


@pytest.mark.parametrize("S", [1, 15, 24, 40, 64, 100])
def test_chunk_scan_matches_the_reference(S):
    """The same fp32 inputs through both scans at the block's chunk: S =
    15 and 24 take one chunk of S, 40 two of 20, 64 two of 32, 100 four
    of 25."""
    r, k, v, w_log, u = _scan_inputs(S)
    H, hd = u.shape
    chunk = layers.rwkv_chunk(S)
    want_y, want_s = RL._rwkv_chunk_scan(*(jnp.asarray(a) for a in
                                           (r, k, v, w_log, u)),
                                         H, hd, chunk=chunk)
    got_y, got_s = layers.rwkv_chunk_scan(
        *(torch.from_numpy(a) for a in (r, k, v, w_log, u)), chunk)
    assert got_y.dtype == got_s.dtype == torch.float32
    assert tuple(got_y.shape) == want_y.shape
    assert tuple(got_s.shape) == want_s.shape
    assert _rel(want_y, got_y) < SCAN_TOL
    assert _rel(want_s, got_s) < SCAN_TOL


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 20), (24, 24), (15, 5)])
def test_chunk_scan_is_the_step_recurrence(S, chunk):
    """y_t = r_t (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(exp(w_t)) S_{t-1}
    + k_t v_t^T, in fp64, step by step (the reference's own test)."""
    r, k, v, w_log, u = _scan_inputs(S, seed=S)
    y, state = layers.rwkv_chunk_scan(
        *(torch.from_numpy(a) for a in (r, k, v, w_log, u)), chunk)
    B, _, H, hd = r.shape
    rn, kn, vn, wn, un = (a.astype(np.float64) for a in (r, k, v, w_log, u))
    ys = np.zeros((B, S, H, hd))
    st = np.zeros((B, H, hd, hd))
    for t in range(S):
        kv = np.einsum("bhk,bhv->bhkv", kn[:, t], vn[:, t])
        ys[:, t] = np.einsum("bhk,bhkv->bhv", rn[:, t],
                             st + un[None, :, :, None] * kv)
        st = np.exp(wn[:, t])[..., None] * st + kv
    np.testing.assert_allclose(y.double().numpy(), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.double().numpy(), st, rtol=2e-4,
                               atol=2e-4)


def test_chunk_choice_is_the_references():
    """The reference's `32 if S % 32 == 0 else (S if S < 32 else
    _chunk(S, 32))` (`layers.py:957`)."""
    sizes = (1, 15, 31, 32, 40, 100, 2047, 2048)
    assert [layers.rwkv_chunk(S) for S in sizes] == \
        [32 if S % 32 == 0 else (S if S < 32 else RL._chunk(S, 32))
         for S in sizes] == [1, 15, 31, 32, 20, 25, 23, 32]


@pytest.mark.parametrize("S", [1, 15, 24, 40])
def test_rwkv_block_train_and_prefill_match(S):
    ref_cfg, tp, cp, rwkv, cmix = _blocks()
    rng = np.random.default_rng(S)
    xf = rng.normal(size=(2, S, ref_cfg.d_model)).astype(np.float32)
    x = jnp.asarray(xf, jnp.bfloat16)
    tx = torch.from_numpy(_np(x)).bfloat16()
    for mode in ("train", "prefill"):
        want, rc = RL.rwkv_block(tp, x, _ctx(ref_cfg, mode), None)
        got, cache = layers.rwkv_block(rwkv, tx, ref_cfg, mode, None)
        assert got.dtype == torch.bfloat16 and _rel(want, got) < BLOCK_TOL
        want_c, rc2 = RL.rwkv_channel_mix(cp, x, _ctx(ref_cfg, mode), None)
        got_c, cache2 = layers.rwkv_channel_mix(cmix, tx, mode, None)
        assert _rel(want_c, got_c) < BLOCK_TOL
        if mode == "train":
            assert cache is None and cache2 is None
            continue
        assert cache.keys() == rc.keys() == {"state", "shift"}
        assert cache2.keys() == rc2.keys() == {"shift_c"}
        assert cache["state"].dtype == torch.float32
        assert _rel(rc["state"], cache["state"]) < BLOCK_TOL
        assert np.array_equal(_bits(rc["shift"]), _bits(cache["shift"]))
        assert np.array_equal(_bits(rc2["shift_c"]), _bits(cache2["shift_c"]))


def test_rwkv_decode_matches_and_writes_the_cache_in_place():
    """Prefill 7 tokens, then decode 4 one at a time through the
    time-mix and the channel-mix: each step's outputs and the new state and
    shifts agree with the reference's, the port's step writes them into
    the cache tensors it was given, and the decoded state is the prefill's
    of all 11 tokens."""
    ref_cfg, tp, cp, rwkv, cmix = _blocks(seed=2)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(2, 11, ref_cfg.d_model)), jnp.bfloat16)
    tx = torch.from_numpy(_np(x)).bfloat16()
    _, rc = RL.rwkv_block(tp, x[:, :7], _ctx(ref_cfg, "prefill"), None)
    _, rc2 = RL.rwkv_channel_mix(cp, x[:, :7], _ctx(ref_cfg, "prefill"), None)
    rc = {**rc, **rc2}
    _, pc = layers.rwkv_block(rwkv, tx[:, :7], ref_cfg, "prefill", None)
    _, pc2 = layers.rwkv_channel_mix(cmix, tx[:, :7], "prefill", None)
    cache = {name: t.clone() for name, t in {**pc, **pc2}.items()}
    for i in range(7, 11):
        ctx = _ctx(ref_cfg, "decode", jnp.int32(i))
        want, c1 = RL.rwkv_block(tp, x[:, i:i + 1], ctx, rc)
        want_c, c2 = RL.rwkv_channel_mix(cp, x[:, i:i + 1], ctx, rc)
        rc = {**c1, **c2}
        leaves = dict(cache)
        got, new = layers.rwkv_block(rwkv, tx[:, i:i + 1], ref_cfg,
                                     "decode", cache)
        got_c, new2 = layers.rwkv_channel_mix(cmix, tx[:, i:i + 1],
                                              "decode", cache)
        assert new is cache and new2 is cache
        assert all(cache[n] is t for n, t in leaves.items())
        assert _rel(want, got) < BLOCK_TOL
        assert _rel(want_c, got_c) < BLOCK_TOL
        assert _rel(rc["state"], cache["state"]) < BLOCK_TOL
        for name in ("shift", "shift_c"):
            assert np.array_equal(_bits(rc[name]), _bits(cache[name]))
    _, full = layers.rwkv_block(rwkv, tx, ref_cfg, "prefill", None)
    assert torch.equal(cache["shift"], full["shift"])
    torch.testing.assert_close(cache["state"], full["state"], rtol=1e-4,
                               atol=1e-4 * full["state"].abs().max().item())


def test_rwkv_block_grads_match_the_reference_in_fp32():
    """d(out . g)/d(every leaf, x) of the time-mix then the channel-mix,
    in fp32 in both packages, against the reference's VJP."""
    ref_cfg, tp, cp, rwkv, cmix = _blocks(seed=3)
    tp32, cp32 = (jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
                  for p in (tp, cp))
    rng = np.random.default_rng(3)
    xf = rng.normal(size=(2, 40, ref_cfg.d_model)).astype(np.float32)
    gf = rng.normal(size=(2, 40, ref_cfg.d_model)).astype(np.float32)

    def f(tp, cp, x):
        h, _ = RL.rwkv_block(tp, x, _ctx(ref_cfg, "train"), None)
        out, _ = RL.rwkv_channel_mix(cp, x + h, _ctx(ref_cfg, "train"), None)
        return (out * gf).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(tp32, cp32, jnp.asarray(xf))
    rwkv.float().requires_grad_(True)
    cmix.float().requires_grad_(True)
    tx = torch.from_numpy(xf).requires_grad_()
    h, _ = layers.rwkv_block(rwkv, tx, ref_cfg, "train", None)
    out, _ = layers.rwkv_channel_mix(cmix, tx + h, "train", None)
    (out * torch.from_numpy(gf)).sum().backward()
    for name, g in want[0].items():
        assert _rel(g, getattr(rwkv, name).grad) < GRAD_TOL, name
    for name, g in want[1].items():
        assert _rel(g, getattr(cmix, name).grad) < GRAD_TOL, name
    assert _rel(want[2], tx.grad) < GRAD_TOL


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = params_from_jax(cfg, _host(params), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    return ref_cfg, cfg, params, model, tokens


def test_smoke_model_prefill_decode_and_train_match(smoke):
    """rwkv6 SMOKE (2 layers, 4 wkv heads of 16): train logits over 40
    tokens (two chunks of 20), a prefill of 36 and 4 decode steps against
    the reference's, and no attention anywhere."""
    ref_cfg, cfg, params, model, tokens = smoke
    from repro_torch.kernels import flash_attention as fak
    x = jnp.asarray(tokens, jnp.int32)
    t = torch.from_numpy(tokens)
    want, _, _ = ref_forward(params, x, ref_cfg, mode="train")
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, _, _ = forward(model, t, mode="train")
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == (0, 0, 0)
    assert _rel(want, got) < TOL
    want_p, rc, _ = ref_forward(params, x[:, :36], ref_cfg, mode="prefill")
    got_p, cache, _ = forward(model, t[:, :36], mode="prefill")
    assert _rel(want_p, got_p) < TOL
    rc = ref_pad_cache_to(rc, ref_cfg, 48)
    cache = pad_cache_to(cache, cfg, 48)
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(rc)] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", ""))
        for p, b in jax.tree_util.tree_leaves_with_path(cache)]
    for i in range(36, 40):
        want_d, rc, _ = ref_forward(params, x[:, i:i + 1], ref_cfg,
                                    mode="decode", cache=rc,
                                    pos=jnp.int32(i))
        got_d, cache2, _ = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
        assert cache2 is cache
        assert _rel(want_d, got_d) < TOL
        assert _rel(_np(got[:, i]), got_d[:, 0]) < TOL
    # token by token from a zeroed cache: the prefill's last logits
    cache = init_cache(cfg, 2, 8, device="cpu")
    for i in range(12):
        step, cache, _ = forward(model, t[:, i:i + 1], mode="decode",
                                 cache=cache, pos=i)
    assert _rel(_np(got[:, 11]), step[:, 0]) < TOL


def test_tree_and_checkpoint_round_trip_across_packages(smoke):
    """The tree the port holds is the reference's byte for byte (fp32
    `decay_base` and `bonus` beside bf16 leaves); both managers save it
    as the same blocks, and each restores the other's after a node
    loss, degraded and cluster-local."""
    _, _, params, model, _ = smoke
    want = jax.tree_util.tree_leaves_with_path(_host(params))
    saved = params_to_tree(model)
    got = jax.tree_util.tree_leaves_with_path(saved)
    assert [p for p, _ in want] == [p for p, _ in got]
    fp32 = set()
    for (path, a), (_, b) in zip(want, got):
        assert np.array_equal(a, _bits(b)), path
        if b.dtype == torch.float32:
            fp32.add(jax.tree_util.keystr(path).split("[")[-1])
    assert fp32 == {"'decay_base']", "'bonus']"}
    ref = RefManager(RefStore(RefTopology(4, 8)), ref_make_unilrc(1, 4),
                     block_size=4096, backend="numpy")
    mgr = CheckpointManager(BlockStore(Topology(4, 8)), make_unilrc(1, 4),
                            block_size=4096, backend=TorchBackend("cpu"))
    assert mgr.save(saved, step=1) == ref.save(_host(params), step=1)
    for key, data in ref.store._blocks.items():
        assert bytes(mgr.store._blocks[key]) == bytes(data), key
    node = mgr.store.node_of(0, 0)
    mgr.store.fail_node(node)
    ref.store.fail_node(node)
    back, report = mgr.restore()
    ref_back, ref_report = ref.restore()
    assert report.degraded_blocks == ref_report.degraded_blocks > 0
    assert report.cross_cluster_bytes == ref_report.cross_cluster_bytes == 0
    for a, b, c, d in zip(jax.tree_util.tree_leaves(params),
                          jax.tree_util.tree_leaves(back),
                          jax.tree_util.tree_leaves(saved),
                          jax.tree_util.tree_leaves(ref_back), strict=True):
        assert np.array_equal(_bits(a), _bits(b))
        assert np.array_equal(_bits(c), _bits(d))


def test_full_width_rwkv6_matches_the_reference_layout():
    """rwkv6-7b at full width on the meta device: 32 layers of 64 wkv
    heads of 64, the reference's leaves, shapes and dtypes. Its six d x d
    matrices a layer make 7.52 B parameters; `param_count()` counts five
    (6.98 B), in both packages."""
    cfg = get_config(ARCH)
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config(ARCH)))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert sum(b.numel() for _, b in got) == 7_517_638_656
    assert sum(b.numel() * b.element_size() for _, b in got) == \
        15_035_801_600
    assert cfg.param_count() == ref_get_config(ARCH).param_count() == \
        6_979_846_144
    assert _block_cache_spec("rwkv", cfg, 4, 2080) == {
        "state": ((4, 64, 64, 64), torch.float32),
        "shift": ((4, 4096), torch.bfloat16),
        "shift_c": ((4, 4096), torch.bfloat16)}
