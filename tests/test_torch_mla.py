"""The port's MLA block (`mla`, minicpm3) against the reference, on the CPU.

The reference's weights (`init_mla`, `init_params` with PRNGKey(0)) go
into the port through `params_from_jax`; the same inputs (numpy, from a
seed) go through both. The reference attends on the absorbed latent: q
and k are kv_lora + rope wide, v is kv_lora wide, one kv head, blockwise
in jnp (`_flash_fwd_impl`). The port does so in decode only (against the
latent cache); over the call's own tokens (train, prefill) it attends in
the per-head form, each head's q, k (nope + rope) and v zero-padded to a
flash kernel instance (64 at SMOKE), through the kernel's wrapper (its
plain version `flash_attention_fwd_plain` on the CPU). Both round every
matmul to bf16. Tolerances:

- `mla_block`'s output, prefill and decode: 2e-2 of max |out| (measured
  when this test was written: at most 4.8e-3); the latent cache it
  returns: 2e-2 of max |leaf| (measured: equal);
- the per-head form against the absorbed form on the same weights and
  input: 1e-4 of max |out| in fp32, `BLOCK_TOL` in bf16; ghost heads'
  attention outputs exactly zero;
- the model's logits, train, prefill and every decode step: 5e-2 of max
  |logit|, the bound `tests/test_archs.py` holds decode against train
  with, as `tests/test_torch_model.py` does (measured: at most 1.5e-2
  against the reference, 2.1e-2 for the port's token-by-token decode
  against its prefill); a padded prefill cache after two layers: 2e-2
  (measured: 9.5e-3);
- the attention backward at MLA's shape (dk 288, dv 256, one kv head,
  48 q heads) against the reference's custom VJP: 2e-2 of max |grad|,
  as `tests/test_torch_train.py` holds the flash backward (measured:
  5.6e-3 in bf16, 6.9e-7 in fp32);
- parameter trees and checkpoints: byte for byte.
"""
import copy
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
from repro.models.layers import flash_attention as ref_flash
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import pad_cache_to as ref_pad_cache_to
from repro.topo import Topology as RefTopology
from repro_torch.ckpt import BlockStore, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import make_unilrc
from repro_torch.io import TorchBackend
from repro_torch.kernels import flash_attention as fak
from repro_torch.models import (abstract_params, forward, init_cache,
                                init_params, layers, pad_cache_to,
                                params_from_jax, params_to_tree)
from repro_torch.topo import Topology

from mla_absorbed import absorbed_prefill

ARCH = "minicpm3-4b"
BLOCK_TOL = 2e-2
TOL = 5e-2
S = 20

# config changes of each variant: SMOKE (4 heads), and 4 heads padded to
# 8 with ghost heads
VARIANTS = {
    "smoke": {},
    "ghost_heads": {"name": "minicpm3-ghost", "tp_pad_heads": 8},
}


def _configs(variant):
    ref = ref_get_config(ARCH, smoke=True)
    port = get_config(ARCH, smoke=True)
    changes = VARIANTS[variant]
    if changes:
        ref = dataclasses.replace(ref, **changes)
        port = dataclasses.replace(port, **changes)
    return ref, port


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


def _rel(want, got) -> float:
    a = np.asarray(want, np.float32)
    b = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    ref_cfg, cfg = _configs(request.param)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = params_from_jax(cfg, _host(params), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    return ref_cfg, cfg, params, model, tokens


def _block_inputs(cfg, seed=1):
    x = np.random.default_rng(seed).normal(size=(2, S, cfg.d_model))
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))


def test_mla_block_prefill_matches_reference(variant):
    ref_cfg, cfg, params, model, _ = variant
    p = params["segments"][0][0]["mla"]
    layer0 = jax.tree_util.tree_map(lambda a: a[0], p)
    xj, xt = _block_inputs(cfg)
    want, wc = RL.mla_block(layer0, xj, RL.Ctx(cfg=ref_cfg, mode="prefill",
                                               pos=None), None)
    layers.reset_blockwise_calls()
    fak.reset_counts()
    with torch.inference_mode():
        got, gc = layers.mla_block(model.blocks[0].mla, xt, cfg, "prefill",
                                   None, None)
    # the per-head form at (64, 64): the kernel's plain version, once
    assert (layers.blockwise_calls, fak.plain_calls) == (0, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel(want, got) < BLOCK_TOL
    for name in ("ckv", "kr"):
        assert tuple(gc[name].shape) == wc[name].shape
        assert _rel(wc[name], gc[name]) < BLOCK_TOL, name


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_per_head_prefill_matches_the_absorbed_form(variant, dtype,
                                                    monkeypatch):
    """`mla_block`'s prefill (the per-head form, zero-padded to the kernel
    instance 64) against the absorbed form on the same weights and input:
    each head's attention output and the block's output within 1e-4 of
    max |out| in fp32 and `BLOCK_TOL` in bf16; the ghost heads' outputs
    and the padding's columns exactly zero; `mla_per_head_calls` counts
    the prefill and not a decode step, which stays absorbed."""
    _, cfg, _, model, _ = variant
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tol = BLOCK_TOL if dtype == "bf16" else 1e-4
    m = copy.deepcopy(model.blocks[0].mla).to(td)
    x = _block_inputs(cfg)[1].to(td)
    c, H = cfg.mla, cfg.num_heads
    assert layers.mla_head_dim(c.qk_nope_head_dim + c.qk_rope_head_dim,
                               c.v_head_dim) == 64
    with torch.inference_mode():
        layers.reset_blockwise_calls()
        want_heads, want = absorbed_prefill(m, x, cfg)
        assert layers.blockwise_calls == 1             # 288 / 256
        seen = []
        inner = layers.flash_attention

        def tap(q, k, v, **kw):
            seen.append((q.shape, k.shape, v.shape, inner(q, k, v, **kw)))
            return seen[-1][-1]
        monkeypatch.setattr(layers, "flash_attention", tap)
        layers.reset_mla_per_head_calls()
        layers.reset_blockwise_calls()
        got, cache = layers.mla_block(m, x, cfg, "prefill", None, None)
        assert (layers.mla_per_head_calls, layers.blockwise_calls) == (1, 0)
        cache = {k: torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                 for k, t in cache.items()}
        layers.mla_block(m, x[:, :1], cfg, "decode", cache, S)
    assert layers.mla_per_head_calls == 1 and len(seen) == 1
    (qs, ks, vs, out), = seen
    Hp = cfg.num_heads_padded
    assert qs == ks == vs == (2, Hp, S, 64) and out.dtype == td
    assert not out[:, H:].any()                   # ghost heads
    assert not out[..., c.v_head_dim:].any()      # v's zero columns
    got_heads = out[..., :c.v_head_dim].transpose(1, 2)
    assert _rel(want_heads[:, :, :H].float().numpy(), got_heads[:, :, :H]) \
        < tol
    assert got.dtype == td and _rel(want.float().numpy(), got) < tol


def test_mla_block_decode_matches_reference(variant):
    """One token at position S - 1 against a latent cache filled by the
    reference's prefill of S - 1 tokens (the same cache in both)."""
    ref_cfg, cfg, params, model, _ = variant
    layer0 = jax.tree_util.tree_map(lambda a: a[0],
                                    params["segments"][0][0]["mla"])
    xj, xt = _block_inputs(cfg, seed=2)
    _, wc = RL.mla_block(layer0, xj[:, :S - 1],
                         RL.Ctx(cfg=ref_cfg, mode="prefill", pos=None), None)
    cache = {k: jnp.pad(v, ((0, 0), (0, 5), (0, 0))) for k, v in wc.items()}
    want, wnew = RL.mla_block(layer0, xj[:, S - 1:],
                              RL.Ctx(cfg=ref_cfg, mode="decode",
                                     pos=jnp.int32(S - 1)), cache)
    tcache = {k: torch.from_numpy(_bits(v).view(np.int16).copy()).view(
        torch.bfloat16) for k, v in cache.items()}
    with torch.inference_mode():
        got, gnew = layers.mla_block(model.blocks[0].mla, xt[:, S - 1:], cfg,
                                     "decode", tcache, S - 1)
    assert gnew["ckv"] is tcache["ckv"]               # written in place
    assert _rel(want, got) < BLOCK_TOL
    for name in ("ckv", "kr"):
        assert _rel(wnew[name], gnew[name]) < BLOCK_TOL, name
        # the rows before `pos` are the prefill's, untouched
        assert np.array_equal(_bits(gnew[name])[:, :S - 1],
                              _bits(cache[name])[:, :S - 1])


def test_model_logits_match_reference(variant):
    """Train logits, a prefill of S - 1 tokens and then four decode steps,
    each step's logits against the reference's."""
    ref_cfg, cfg, params, model, tokens = variant
    x = jnp.asarray(tokens, jnp.int32)
    t = torch.from_numpy(tokens)
    want, _, waux = ref_forward(params, x, ref_cfg, mode="train")
    got, _, aux = forward(model, t, mode="train")
    assert float(aux) == float(waux) == 0.0
    assert _rel(want, got) < TOL
    P = S - 4
    wp, rc, _ = ref_forward(params, x[:, :P], ref_cfg, mode="prefill")
    rc = ref_pad_cache_to(rc, ref_cfg, S + 2)
    gp, cache, _ = forward(model, t[:, :P], mode="prefill")
    assert _rel(wp, gp) < TOL
    cache = pad_cache_to(cache, cfg, S + 2)
    for i in range(P, S):
        wd, rc, _ = ref_forward(params, x[:, i:i + 1], ref_cfg, mode="decode",
                                cache=rc, pos=jnp.int32(i))
        gd, cache, _ = forward(model, t[:, i:i + 1], mode="decode",
                               cache=cache, pos=i)
        assert _rel(wd, gd) < TOL, i
        # decode after prefill agrees with the train logits at that position
        assert _rel(got[:, i].float().numpy(), gd[:, 0]) < TOL, i


def test_decode_from_a_zeroed_cache_matches_prefill(variant):
    _, cfg, _, model, tokens = variant
    t = torch.from_numpy(tokens[:, :8])
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache[0][0].items()} == {
        "ckv": (2, 2, 8, cfg.mla.kv_lora_rank),
        "kr": (2, 2, 8, cfg.mla.qk_rope_head_dim)}
    for i in range(8):
        logits, cache, _ = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
    want, _, _ = forward(model, t, mode="prefill")
    assert _rel(want[:, -1].float().numpy(), logits[:, 0]) < TOL


def test_pad_cache_to_pads_the_latent_like_the_reference(variant):
    ref_cfg, cfg, params, model, tokens = variant
    _, rc, _ = ref_forward(params, jnp.asarray(tokens[:, :9], jnp.int32),
                           ref_cfg, mode="prefill")
    _, cache, _ = forward(model, torch.from_numpy(tokens[:, :9]),
                          mode="prefill")
    want = ref_pad_cache_to(rc, ref_cfg, 16)
    got = pad_cache_to(cache, cfg, 16)
    for name in ("ckv", "kr"):
        w, g = want[0][0][name], got[0][0][name]
        assert tuple(g.shape) == w.shape and g.shape[2] == 16
        assert not g[:, :, 9:].any()                  # zero padding
        assert _rel(w[:, :, :9], g[:, :, :9]) < BLOCK_TOL
    # a cache already S_max long comes back as it is
    again = pad_cache_to(got, cfg, 16)
    assert again[0][0]["ckv"] is got[0][0]["ckv"]


def test_tree_round_trip_is_byte_exact(variant):
    _, _, params, model, _ = variant
    want = jax.tree_util.tree_leaves_with_path(_host(params))
    got = jax.tree_util.tree_leaves_with_path(params_to_tree(model))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert b.dtype == torch.bfloat16, path
        assert np.array_equal(a, _bits(b)), path


def test_ghost_heads_stay_zero_and_shapes_are_the_references():
    ref_cfg, cfg = _configs("ghost_heads")
    assert (cfg.num_heads, cfg.num_heads_padded) == (4, 8)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c, H = cfg.mla, cfg.num_heads
    qk = c.qk_nope_head_dim + c.qk_rope_head_dim
    for block in model.blocks:
        m = block.mla
        assert m.w_uq.shape == (c.q_lora_rank, 8 * qk)
        assert not m.w_uq[:, H * qk:].any() and m.w_uq[:, :H * qk].any()
        assert not m.w_uk[H:].any() and not m.w_uv[H:].any()
        assert not m.wo[H * c.v_head_dim:].any()
        assert m.w_uk[:H].any() and m.w_uv[:H].any()
    want = jax.tree_util.tree_leaves_with_path(ref_abstract_params(ref_cfg))
    got = jax.tree_util.tree_leaves_with_path(params_to_tree(model))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in want] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]


def test_checkpoint_restores_across_packages(variant):
    """Both managers save the same MLA weights as the same blocks; after a
    node is lost each restores degraded, cluster-local, and each restored
    tree is the other's saved tree byte for byte."""
    _, _, params, model, _ = variant
    ref = RefManager(RefStore(RefTopology(4, 8)), ref_make_unilrc(1, 4),
                     block_size=4096, backend="numpy")
    mgr = CheckpointManager(BlockStore(Topology(4, 8)), make_unilrc(1, 4),
                            block_size=4096, backend=TorchBackend("cpu"))
    saved = params_to_tree(model)
    assert mgr.save(saved, step=3) == ref.save(_host(params), step=3)
    for key, data in ref.store._blocks.items():
        assert bytes(mgr.store._blocks[key]) == bytes(data), key
    node = mgr.store.node_of(0, 0)
    mgr.store.fail_node(node)
    ref.store.fail_node(node)
    got, report = mgr.restore()
    want, ref_report = ref.restore()
    assert report.degraded_blocks == ref_report.degraded_blocks > 0
    assert report.cross_cluster_bytes == ref_report.cross_cluster_bytes == 0
    for a, b, c, d in zip(jax.tree_util.tree_leaves(params),
                          jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves(saved),
                          jax.tree_util.tree_leaves(want), strict=True):
        assert np.array_equal(_bits(a), _bits(b))      # port restores ref's
        assert np.array_equal(_bits(c), _bits(d))      # ref restores port's


def test_full_width_minicpm3_matches_the_reference_layout():
    """minicpm3-4b at full width, on the meta device: 62 layers, 40 heads
    padded to 48, the reference's leaves, shapes and dtypes."""
    cfg = get_config(ARCH)
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config(ARCH)))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert cfg.num_heads_padded == 48 and cfg.num_layers == 62
    assert sum(b.numel() for _, b in got) == 4_395_989_504
    assert sum(b.numel() * b.element_size() for _, b in got) == \
        8_791_979_008
    assert cfg.param_count() == 4_261_836_800


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_attention_backward_at_the_mla_head_dims(dtype):
    """The blockwise forward and backward at minicpm3's absorbed shape:
    q (B, 48, S, 288), k (B, 1, S, 288), v (B, 1, S, 256): dk != dv and
    G = 48 q heads over one kv head."""
    B, Hq, S_, dk, dv = 1, 48, 64, 288, 256
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, Hq, S_, dk)).astype(np.float32)
    k = rng.normal(size=(B, 1, S_, dk)).astype(np.float32)
    v = rng.normal(size=(B, 1, S_, dv)).astype(np.float32)
    do = rng.normal(size=(B, Hq, S_, dv)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32

    def f(q, k, v):
        out = ref_flash(q, k, v, causal=True)
        return (out.astype(jnp.float32) * do).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x, jd)
                                            for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_()
                  for x in (q, k, v))
    layers.reset_blockwise_calls()
    out = layers.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == (B, Hq, S_, dv) and layers.blockwise_calls == 1
    (out.float() * torch.from_numpy(do)).sum().backward()
    for a, t, name in zip(want, (tq, tk, tv), "qkv"):
        assert t.grad.dtype == td and tuple(t.grad.shape) == a.shape
        assert _rel(a, t.grad) < 2e-2, f"d{name}"
