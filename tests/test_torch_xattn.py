"""The port's gated cross-attention (`cross_attn`, llama-3.2-vision-11b)
against the reference, on the CPU: the block in train, prefill and decode
mode and its gradients, the SMOKE model with its vision input, the cache
padding fault ROADMAP C3, the attention backward at the vision length,
trees and checkpoints.

The gates `gate_attn` and `gate_ffn` are zero at init (the reference's
`init_cross_attention`), where the block contributes exactly nothing and
wq, wk, wv, wo and the block's MLP get zero gradients: every test here
sets them to seeded non-zero values first. The reference's weights go into
the port; the same inputs (numpy, from a seed) go through both.
Tolerances:

- the bf16 block's output and cached keys and values: 2e-2 of max |out|;
- the block's gradients in fp32, against the reference's VJP: 1e-4 of
  each gradient's max |value|;
- the SMOKE model's logits (train, prefill, decode steps): 5e-2 of max
  |logit|, the bound `tests/test_archs.py` holds decode against train
  with; at head dim 128, where the port's layer takes the flash kernel's
  wrapper (its plain version on the CPU) and the reference attends in jnp,
  the same 5e-2;
- the attention backward at Skv = 6404 against the reference's
  `_flash_bwd_impl`: 2e-2 of max |grad| in bf16, 1e-4 in fp32, as
  `tests/test_torch_train.py` holds the flash backward;
- trees and checkpoints: byte for byte (the fp32 gates beside bf16
  leaves).
"""
import dataclasses

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
from repro_torch.kernels import flash_attention as fak
from repro_torch.launch import serve
from repro_torch.models import (abstract_params, forward, layers,
                                pad_cache_to, params_from_jax,
                                params_to_tree)
from repro_torch.models.model import _block_cache_spec
from repro_torch.topo import Topology

ARCH = "llama-3.2-vision-11b"
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


def _bf16(arr):
    """(reference bf16 array, port bf16 tensor) of the same values."""
    ref = jnp.asarray(arr, jnp.bfloat16)
    return ref, torch.from_numpy(_np(ref)).bfloat16()


def _ctx(cfg, mode, vision=None, pos=None):
    return RL.Ctx(cfg=cfg, mode=mode, pos=pos, vision=vision,
                  attn_schedule=RL.DEFAULT_ATTN_SCHEDULE, mesh=None,
                  seq_parallel=False)


def _gated(params, seed):
    """`params` with every gate leaf drawn from U(0.3, 0.9)."""
    rng = np.random.default_rng(seed)

    def gate(path, a):
        if "gate_" not in jax.tree_util.keystr(path):
            return a
        return jnp.asarray(rng.uniform(0.3, 0.9, a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(gate, params)


def _block(seed=1):
    """The reference's `init_cross_attention` weights with non-zero gates,
    and the port's `CrossAttention` holding them."""
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    params = _gated(RL.init_cross_attention(jax.random.PRNGKey(seed),
                                            ref_cfg), seed)
    xattn = layers.CrossAttention(cfg, device="cpu")
    for name, leaf in params.items():
        dst = getattr(xattn, name)
        assert tuple(dst.shape) == leaf.shape, name
        assert str(dst.dtype).replace("torch.", "") == str(leaf.dtype), name
        dst.data.copy_(torch.from_numpy(_np(leaf)).to(dst.dtype))
    assert float(xattn.gate_attn) > 0.29
    return ref_cfg, params, xattn


def _inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(2, S, cfg.d_model)))
    vision = _bf16(rng.normal(size=(2, cfg.vision_seq, cfg.d_model)))
    return x, vision


@pytest.mark.parametrize("S", [1, 9, 24])
def test_cross_attention_block_train_and_prefill_match(S):
    ref_cfg, params, xattn = _block()
    (x, tx), (vis, tvis) = _inputs(ref_cfg, S, S)
    for mode in ("train", "prefill"):
        want, rc = RL.cross_attention_block(params, x,
                                            _ctx(ref_cfg, mode, vis), None)
        got, cache = layers.cross_attention_block(xattn, tx, ref_cfg, mode,
                                                  None, tvis)
        assert got.dtype == torch.bfloat16
        assert _rel(want, got) < BLOCK_TOL
        if mode == "train":
            assert cache is None
            continue
        for name in ("k", "v"):                 # (B, Hkv, vision_seq, hd)
            assert tuple(cache[name].shape) == rc[name].shape == \
                (2, 2, ref_cfg.vision_seq, 16)
            assert _rel(rc[name], cache[name]) < BLOCK_TOL


def test_cross_attention_block_decode_reads_the_cache():
    """Decode (S = 1) attends to the cached vision keys and values, not
    causal, and gives the cache back unchanged; the result is the
    reference's decode and the prefill's attention of that token."""
    ref_cfg, params, xattn = _block(seed=2)
    (x, tx), (vis, tvis) = _inputs(ref_cfg, 6, 2)
    _, rc = RL.cross_attention_block(params, x[:, :5],
                                     _ctx(ref_cfg, "prefill", vis), None)
    full, _ = layers.cross_attention_block(xattn, tx, ref_cfg, "prefill",
                                           None, tvis)
    _, cache = layers.cross_attention_block(xattn, tx[:, :5], ref_cfg,
                                            "prefill", None, tvis)
    k, v = cache["k"].clone(), cache["v"].clone()
    want, _ = RL.cross_attention_block(
        params, x[:, 5:], _ctx(ref_cfg, "decode", vis, jnp.int32(5)), rc)
    layers.reset_blockwise_calls()
    got, new = layers.cross_attention_block(xattn, tx[:, 5:], ref_cfg,
                                            "decode", cache, None)
    assert new is cache and torch.equal(cache["k"], k) and \
        torch.equal(cache["v"], v)
    assert layers.blockwise_calls == 1          # flash_attention, Sq = 1
    assert _rel(want, got) < BLOCK_TOL
    assert _rel(_np(full[:, 5:]), got) < BLOCK_TOL


def test_cross_attention_block_grads_match_the_reference_in_fp32():
    """d(out . g) / d(wq, wk, wv, wo, gate_attn, x, vision) with non-zero
    gates, in fp32 in both packages, against the reference's VJP: the
    gradients of wq, wk, wv and wo are zero at init, here they are not."""
    ref_cfg, params, xattn = _block(seed=3)
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(3)
    xf = rng.normal(size=(2, 16, ref_cfg.d_model)).astype(np.float32)
    vf = rng.normal(size=(2, ref_cfg.vision_seq, ref_cfg.d_model)
                    ).astype(np.float32)
    gf = rng.normal(size=(2, 16, ref_cfg.d_model)).astype(np.float32)

    def f(p, x, vis):
        out, _ = RL.cross_attention_block(p, x, _ctx(ref_cfg, "train", vis),
                                          None)
        return (out * gf).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(p32, jnp.asarray(xf),
                                          jnp.asarray(vf))
    xattn.float().requires_grad_(True)
    tx = torch.from_numpy(xf).requires_grad_()
    tv = torch.from_numpy(vf).requires_grad_()
    out, _ = layers.cross_attention_block(xattn, tx, ref_cfg, "train", None,
                                          tv)
    (out * torch.from_numpy(gf)).sum().backward()
    assert xattn.gate_ffn.grad is None          # the block's MLP gate
    for name, g in want[0].items():
        if name == "gate_ffn":
            continue
        assert float(np.abs(_np(g)).max()) > 0, name
        assert _rel(g, getattr(xattn, name).grad) < GRAD_TOL, name
    assert _rel(want[1], tx.grad) < GRAD_TOL
    assert _rel(want[2], tv.grad) < GRAD_TOL


# ---------------------------------------------------------------------------
# the SMOKE model
# ---------------------------------------------------------------------------

def _model(ref_cfg, cfg, seed=0):
    params = _gated(ref_init_params(ref_cfg, jax.random.PRNGKey(seed)), seed)
    return params, params_from_jax(cfg, _host(params), "cpu")


def _unpadded(rc, ref_cfg, S_max):
    """The reference's `pad_cache_to` with its C3 fault taken out: the
    `cross_attn` blocks' vision keys and values keep their length."""
    padded = ref_pad_cache_to(rc, ref_cfg, S_max)
    return tuple(tuple(old if kind == "cross_attn" else new
                       for kind, old, new in zip(seg.blocks, rs, ps))
                 for seg, rs, ps in zip(ref_cfg.segments, rc, padded))


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    params, model = _model(ref_cfg, cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24))
    vision = _bf16(rng.normal(size=(2, cfg.vision_seq, cfg.d_model)))
    return ref_cfg, cfg, params, model, tokens, vision


def test_smoke_model_prefill_decode_and_train_match(smoke):
    """llama-vision SMOKE (4 attn + 1 cross_attn, head dim 16, gates
    non-zero): train logits, a prefill of 20 and 4 decode steps against
    the reference's; every attention blockwise, one call per layer per
    prefill and one per decode step for the cross-attention layer."""
    ref_cfg, cfg, params, model, tokens, (vis, tvis) = smoke
    x, t = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    want, _, _ = ref_forward(params, x, ref_cfg, mode="train", vision=vis)
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, _, _ = forward(model, t, mode="train", vision=tvis)
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == (0, 0, 5)
    assert _rel(want, got) < TOL
    want_p, rc, _ = ref_forward(params, x[:, :20], ref_cfg, mode="prefill",
                                vision=vis)
    got_p, cache, _ = forward(model, t[:, :20], mode="prefill", vision=tvis)
    assert _rel(want_p, got_p) < TOL
    rc = _unpadded(rc, ref_cfg, 28)
    cache = pad_cache_to(cache, cfg, 28)
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(rc)] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", ""))
        for p, b in jax.tree_util.tree_leaves_with_path(cache)]
    layers.reset_blockwise_calls()
    for i in range(20, 24):
        want_d, rc, _ = ref_forward(params, x[:, i:i + 1], ref_cfg,
                                    mode="decode", cache=rc,
                                    pos=jnp.int32(i), vision=vis)
        got_d, cache2, _ = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
        assert cache2 is cache
        assert _rel(want_d, got_d) < TOL
        assert _rel(_np(got[:, i]), got_d[:, 0]) < TOL
    assert layers.blockwise_calls == 4          # the cross-attention layer


def test_gates_open_the_cross_attention(smoke):
    """With the gates at zero (init) the vision input changes nothing;
    with them open it moves the logits, in both packages alike."""
    ref_cfg, cfg, params, model, tokens, (vis, tvis) = smoke
    t = torch.from_numpy(tokens)
    # another image (a permutation of the same keys would change nothing:
    # no position enters cross-attention)
    other = torch.randn(tvis.shape,
                        generator=torch.Generator().manual_seed(9)).bfloat16()
    a, _, _ = forward(model, t, mode="train", vision=tvis)
    b, _, _ = forward(model, t, mode="train", vision=other)
    assert _rel(_np(a), b) > 1e-2
    closed = params_from_jax(cfg, _host(ref_init_params(
        ref_cfg, jax.random.PRNGKey(0))), "cpu")
    a, _, _ = forward(closed, t, mode="train", vision=tvis)
    b, _, _ = forward(closed, t, mode="train", vision=other)
    assert torch.equal(a, b)


def test_c3_reference_padding_dilutes_the_vision_softmax():
    """ROADMAP C3. The reference's `pad_cache_to` pads every 5-D k / v
    leaf to S_max, the cross-attention block's vision keys included, and
    its decode then attends to the zero keys unmasked (score 0). On SMOKE
    (vision_seq 12) with the gates at 0.7, a prefill of 16 and one decode
    step drift from a prefill of 17 more the larger S_max is (measured
    when this test was written: 0.0289, 0.0512 and 0.1110 of max |logit|
    at S_max 17, 24 and 80), where the same decode fed the unpadded
    vision keys drifts 0.0135 at every S_max. The port's `pad_cache_to`
    leaves them at vision_seq, and the port's decode is the reference's
    unpadded one (0.0202 from the prefill of 17) at every S_max."""
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.full(a.shape, 0.7, jnp.float32)
                      if "gate_" in jax.tree_util.keystr(p) else a),
        ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    model = params_from_jax(cfg, _host(params), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 17))
    vis, tvis = _bf16(rng.normal(size=(2, cfg.vision_seq, cfg.d_model)))
    x, t = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    full, _, _ = ref_forward(params, x, ref_cfg, mode="prefill", vision=vis)
    want = full[:, -1]
    _, rc, _ = ref_forward(params, x[:, :16], ref_cfg, mode="prefill",
                           vision=vis)
    _, prefill, _ = forward(model, t[:, :16], mode="prefill", vision=tvis)
    drift, port = {}, {}
    for S_max in (24, 80):
        for name, c in (("padded", ref_pad_cache_to(rc, ref_cfg, S_max)),
                        ("unpadded", _unpadded(rc, ref_cfg, S_max))):
            step, _, _ = ref_forward(params, x[:, 16:], ref_cfg,
                                     mode="decode", cache=c,
                                     pos=jnp.int32(16), vision=vis)
            drift[name, S_max] = _rel(want, step[:, 0])
            if name == "padded":
                assert c[0][4]["k"].shape[3] == S_max
        cache = pad_cache_to(prefill, cfg, S_max)
        assert cache[0][4]["k"].shape[3] == cfg.vision_seq
        assert cache[0][0]["k"].shape[3] == S_max
        got, _, _ = forward(model, t[:, 16:], mode="decode", cache=cache,
                            pos=16)
        port[S_max] = got[:, 0]
        assert _rel(step[:, 0], got[:, 0]) < TOL    # the unpadded decode
        assert _rel(want, got[:, 0]) < TOL
    assert drift["unpadded", 24] == drift["unpadded", 80] < TOL
    assert torch.equal(port[24], port[80])
    assert drift["padded", 24] > 2 * drift["unpadded", 24]
    assert drift["padded", 80] > 5 * drift["unpadded", 80]
    assert drift["padded", 80] > TOL


def test_head_dim_128_takes_the_kernels_route():
    """At head dim 128 the port's cross-attention goes to the flash
    kernel's wrapper (its plain version on the CPU; the kernel on the
    card), in prefill and in decode (Sq = 1), where the reference attends
    in jnp: logits within 5e-2 of max |logit|."""
    changes = dict(name="llama-vision-hd128", head_dim=128)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH, smoke=True),
                                  **changes)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **changes)
    params, model = _model(ref_cfg, cfg, seed=4)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    vis, tvis = _bf16(rng.normal(size=(2, cfg.vision_seq, cfg.d_model)))
    x, t = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    _, rc, _ = ref_forward(params, x[:, :11], ref_cfg, mode="prefill",
                           vision=vis)
    want, _, _ = ref_forward(params, x[:, 11:], ref_cfg, mode="decode",
                             cache=_unpadded(rc, ref_cfg, 16),
                             pos=jnp.int32(11), vision=vis)
    fak.reset_counts()
    layers.reset_blockwise_calls()
    _, cache, _ = forward(model, t[:, :11], mode="prefill", vision=tvis)
    assert (fak.plain_calls, layers.blockwise_calls) == (5, 0)
    got, _, _ = forward(model, t[:, 11:], mode="decode",
                        cache=pad_cache_to(cache, cfg, 16), pos=11)
    assert (fak.launches, fak.plain_calls) == (0, 6)
    assert _rel(want, got) < TOL


def test_serve_vision_on_the_cpu():
    """`--arch llama-3.2-vision-11b` serves its SMOKE config with stub
    vision embeddings: per batch one blockwise call per attention layer
    (4 self, 1 cross) at prefill and one per decode step (the cross
    layer); greedy and deterministic."""
    fak.reset_counts()
    layers.reset_blockwise_calls()
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3",
            "--batch", "2", "--prompt-len", "10", "--gen", "4"]
    out = serve.run(argv)
    assert [t.shape for t in out["tokens"]] == [(2, 4), (1, 4)]
    assert (fak.launches, fak.plain_calls) == (0, 0)
    assert layers.blockwise_calls == 2 * 5 + 2 * 3 * 1
    again = serve.run(argv)
    assert all(torch.equal(a, b) for a, b in zip(out["tokens"],
                                                  again["tokens"]))


# ---------------------------------------------------------------------------
# the attention backward at the vision length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_attention_backward_at_the_vision_length(dtype, monkeypatch):
    """Cross-attention's backward: Sq = 40 queries against Skv = 6404 =
    4 x 1601 keys, not causal. The reference's `_flash_bwd_impl` chunks
    Skv by its largest divisor up to 1024, 4 (1,601 kv chunks); the port
    takes chunks of 1024 with a ragged tail (7 chunks, 7 chunk pairs). The
    sums do not depend on the chunking: the same gradients."""
    B, Hq, Hkv, Sq, Skv, d = 1, 2, 1, 40, 6404, 16
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    rng = np.random.default_rng(6404)
    q, k, v, do = (rng.normal(size=sh).astype(np.float32) for sh in
                   ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d),
                    (B, Hq, Sq, d)))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    out, lse = fak.flash_attention_fwd_plain(tq, tk, tv, causal=False)
    want = RL._flash_bwd_impl(
        *(jnp.asarray(_np(a), jd) for a in (tq, tk, tv, out)),
        jnp.asarray(lse.numpy()).reshape(B, Hkv, Hq // Hkv, Sq),
        jnp.asarray(_np(tdo), jd), False, 0, 0, "masked")
    assert RL._chunk(Skv) == 4
    pairs = []
    inner = layers._pair_mask

    def counted(*args):
        pairs.append(args[:4])
        return inner(*args)
    monkeypatch.setattr(layers, "_pair_mask", counted)
    got = layers.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=False)
    assert pairs == [(0, Sq, k0, min(1024, Skv - k0))
                     for k0 in range(0, Skv, 1024)]
    tol = 2e-2 if dtype == "bf16" else 1e-4
    for a, b, name in zip(want, got, ("dq", "dk", "dv")):
        assert b.dtype == td and tuple(b.shape) == a.shape, name
        assert _rel(a, b) < tol, name


# ---------------------------------------------------------------------------
# trees, checkpoints, full width
# ---------------------------------------------------------------------------

def test_tree_and_checkpoint_round_trip_across_packages(smoke):
    """The tree the port holds is the reference's byte for byte, the
    non-zero fp32 gates (stacked over the segment's layers) included; both
    managers save it as the same blocks and each restores the other's
    after a node loss, degraded and cluster-local."""
    _, _, params, model, _, _ = smoke
    want = jax.tree_util.tree_leaves_with_path(_host(params))
    saved = params_to_tree(model)
    got = jax.tree_util.tree_leaves_with_path(saved)
    assert [p for p, _ in want] == [p for p, _ in got]
    gates = 0
    for (path, a), (_, b) in zip(want, got):
        assert np.array_equal(a, _bits(b)), path
        if "gate_" in jax.tree_util.keystr(path):
            assert b.dtype == torch.float32 and tuple(b.shape) == (1,)
            gates += 1
    assert gates == 2
    ref = RefManager(RefStore(RefTopology(4, 8)), ref_make_unilrc(1, 4),
                     block_size=4096, backend="numpy")
    mgr = CheckpointManager(BlockStore(Topology(4, 8)), make_unilrc(1, 4),
                            block_size=4096, backend=TorchBackend("cpu"))
    assert mgr.save(saved, step=2) == ref.save(_host(params), step=2)
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


def test_full_width_vision_matches_the_reference_layout():
    """llama-3.2-vision-11b at full width on the meta device: 8 x (4 attn +
    1 cross_attn), 32 / 8 heads of 128, the reference's leaves, shapes
    and dtypes; the cross-attention cache holds the 6,404 vision keys."""
    cfg = get_config(ARCH)
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config(ARCH)))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert sum(b.numel() for _, b in got) == 9_775_157_264
    assert sum(b.numel() * b.element_size() for _, b in got) == \
        19_550_314_560
    assert (cfg.num_heads_padded, cfg.num_kv_heads_padded,
            cfg.resolved_head_dim) == (32, 8, 128)
    assert _block_cache_spec("cross_attn", cfg, 4, 2080) == {
        "k": ((4, 8, 6404, 128), torch.bfloat16),
        "v": ((4, 8, 6404, 128), torch.bfloat16)}
