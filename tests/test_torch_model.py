"""The port's models and server against the reference, on the CPU.

The reference's `init_params(cfg, PRNGKey(0))` weights go into the port
through `params_from_jax`; the same token ids (numpy, from a seed) go
through both `forward`s. At the SMOKE head dim (16), which no flash kernel
takes, both run their blockwise attention (the reference's jnp
`_flash_fwd_impl`, the port's `flash_attention_fwd_plain`), and both
round every matmul to bf16: logits must agree within 5e-2 of max |logit|,
the bound `tests/test_archs.py` holds decode against train with. Measured
when this test was written: 0.0124 (train) and 0.0100 (decode) of max
|logit| at llama3.2 SMOKE, 0.0103 and 0.0061 with ghost heads; at
recurrentgemma SMOKE (rg, rg, local_attn, rg, rg; window 8) 0.0320 and
0.0153, and 0.0196 and 0.0133 at head dim 256, which takes the flash
kernel's wrapper (its plain version on the CPU), as the reference hands
it its Pallas kernel on a TPU. phi4-mini SMOKE has llama SMOKE's shapes
(0.0124 and 0.0100); qwen1.5 SMOKE, with its qkv bias, 0.0101 and 0.0112.
rwkv6 SMOKE (two `rwkv` layers, no attention) and llama-vision SMOKE (4
`attn` + 1 `cross_attn`, its gates set non-zero, a stub vision input) run
the same tests; the vision model's decode is compared with the reference's
on a cache padded without the reference's fault C3 (its vision keys and
values keep their length, `tests/test_torch_xattn.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import pad_cache_to as ref_pad_cache_to
from repro_torch.configs import PORTED, all_archs, get_config
from repro_torch.kernels import flash_attention as fak
from repro_torch.launch import serve
from repro_torch.models import (abstract_params, forward, init_cache,
                                init_params, layers, pad_cache_to,
                                params_from_jax, params_to_tree)

TOL = 5e-2
S = 24


def _configs(pad: int, arch: str = "llama3.2-3b", **changes):
    """(reference, port) SMOKE configs of `arch`, with ghost heads when
    pad > 0 (llama: 6 q heads padded to 8 over 2 kv heads) and any other
    field `changes` names (a name is given to the changed config)."""
    ref = ref_get_config(arch, smoke=True)
    port = get_config(arch, smoke=True)
    if pad:
        changes = dict(changes, name="llama3.2-ghost", tp_pad_heads=pad)
    if changes:
        ref = dataclasses.replace(ref, **changes)
        port = dataclasses.replace(port, **changes)
    return ref, port


# (ghost-head pad, arch, config changes) of each `pair`; recurrentgemma's
# SMOKE has window 8, so S = 24 prefills and decodes past the window
PAIRS = {
    "smoke": (0, "llama3.2-3b", {}),
    "ghost_heads": (4, "llama3.2-3b", {}),
    "phi4_mini_smoke": (0, "phi4-mini-3.8b", {}),
    "qwen15_smoke": (0, "qwen1.5-32b", {}),               # qkv bias
    "recurrentgemma_smoke": (0, "recurrentgemma-9b", {}),
    "recurrentgemma_head_dim_256": (0, "recurrentgemma-9b",
                                    {"name": "recurrentgemma-hd256",
                                     "head_dim": 256}),
    "rwkv6_smoke": (0, "rwkv6-7b", {}),
    "vision_smoke": (0, "llama-3.2-vision-11b", {}),
}


def _attention_layers(cfg) -> int:
    return sum(seg.count * sum(kind not in ("rg", "rwkv")
                               for kind in seg.blocks)
               for seg in cfg.segments)


def _gated(params, seed):
    """`params` with every cross-attention gate drawn from U(0.3, 0.9): at
    init they are 0 and the block adds nothing."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(rng.uniform(0.3, 0.9, a.shape), jnp.float32)
                      if "gate_" in jax.tree_util.keystr(p) else a), params)


def _ref_pad(rc, ref_cfg, S_max):
    """The reference's `pad_cache_to` without its fault C3: `cross_attn`
    blocks keep their vision keys and values unpadded."""
    padded = ref_pad_cache_to(rc, ref_cfg, S_max)
    return tuple(tuple(old if kind == "cross_attn" else new
                       for kind, old, new in zip(seg.blocks, rs, ps))
                 for seg, rs, ps in zip(ref_cfg.segments, rc, padded))


def _tree_numpy(params):
    """The reference tree as numpy, bf16 leaves as uint16 bit views."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), params)


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    pad, arch, changes = PAIRS[request.param]
    ref_cfg, cfg = _configs(pad, arch, **changes)
    params = _gated(ref_init_params(ref_cfg, jax.random.PRNGKey(0)), 0)
    model = params_from_jax(cfg, _tree_numpy(params), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, S))
    vision = (None, None)
    if cfg.family == "vlm":
        ref = jnp.asarray(rng.normal(size=(2, cfg.vision_seq, cfg.d_model)),
                          jnp.bfloat16)
        vision = (ref, torch.from_numpy(np.array(ref.astype(jnp.float32)))
                  .bfloat16())
    return ref_cfg, cfg, params, model, tokens, vision


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else b
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_train_logits_match(pair):
    ref_cfg, _, params, model, tokens, (vis, tvis) = pair
    want, _, _ = ref_forward(params, jnp.asarray(tokens, jnp.int32), ref_cfg,
                             mode="train", vision=vis)
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, cache, aux = forward(model, torch.from_numpy(tokens), mode="train",
                              vision=tvis)
    assert cache is None and float(aux) == 0.0
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel(want, got) < TOL
    # head dim 16 is routed off the flash kernel: blockwise, one per
    # attention layer; 256 goes to the kernel's wrapper (plain on the CPU)
    n = _attention_layers(ref_cfg)
    assert fak.launches == 0
    if ref_cfg.resolved_head_dim % 128 == 0:
        assert (fak.plain_calls, layers.blockwise_calls) == (n, 0)
    else:
        assert (fak.plain_calls, layers.blockwise_calls) == (0, n)


def test_prefill_and_decode_logits_match(pair):
    ref_cfg, cfg, params, model, tokens, (vis, tvis) = pair
    x = jnp.asarray(tokens, jnp.int32)
    want_p, rc, _ = ref_forward(params, x[:, :S - 1], ref_cfg, mode="prefill",
                                vision=vis)
    rc = _ref_pad(rc, ref_cfg, S + 4)
    want_d, _, _ = ref_forward(params, x[:, S - 1:], ref_cfg, mode="decode",
                               cache=rc, pos=jnp.int32(S - 1), vision=vis)
    t = torch.from_numpy(tokens)
    got_p, cache, _ = forward(model, t[:, :S - 1], mode="prefill",
                              vision=tvis)
    assert _rel(want_p, got_p) < TOL
    if not ref_cfg.window and "k" in cache[0][0]:
        k = cache[0][0]["k"]
        assert k.shape == rc[0][0]["k"].shape[:3] + (S - 1,) + k.shape[4:]
    cache = pad_cache_to(cache, cfg, S + 4)
    # the padded cache has the reference's leaves: names, shapes, dtypes
    # (a window cache stays window-sized, a recurrent state fixed-size)
    want_leaves = jax.tree_util.tree_leaves_with_path(rc)
    got_leaves = jax.tree_util.tree_leaves_with_path(cache)
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in want_leaves] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got_leaves]
    got_d, cache2, _ = forward(model, t[:, S - 1:], mode="decode", cache=cache,
                               pos=S - 1)
    assert cache2 is cache                        # written in place
    assert _rel(want_d, got_d) < TOL
    # the port's own decode against its train logits, as test_archs does
    got_t, _, _ = forward(model, t, mode="train", vision=tvis)
    assert _rel(got_t[:, -1].float().numpy(), got_d[:, 0]) < TOL


def test_decode_from_a_zeroed_cache_matches_prefill(pair):
    """Token by token from a zeroed cache, then one prefill: the last
    logits agree. With a window (recurrentgemma: 8) the decode runs all
    S = 24 tokens, three times past the window. A vision model's decode
    reads the image's keys and values from the cache, which only a
    prefill fills: they are copied in from one first."""
    _, cfg, _, model, tokens, (_, tvis) = pair
    n, cap = (S, S) if cfg.window else (6, 8)
    t = torch.from_numpy(tokens[:, :n])
    cache = init_cache(cfg, 2, cap, device="cpu")
    if tvis is not None:
        _, filled, _ = forward(model, t[:, :1], mode="prefill", vision=tvis)
        for seg, blocks, new in zip(cfg.segments, cache, filled):
            for kind, block, nb in zip(seg.blocks, blocks, new):
                if kind == "cross_attn":
                    for name in block:
                        block[name].copy_(nb[name])
    for i in range(n):
        logits, cache, _ = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
    want, _, _ = forward(model, t, mode="prefill", vision=tvis)
    assert _rel(want[:, -1].float().numpy(), logits[:, 0]) < TOL


def test_tree_round_trip_is_byte_exact(pair):
    _, _, params, model, _, _ = pair
    want = jax.tree_util.tree_leaves_with_path(_tree_numpy(params))
    got = jax.tree_util.tree_leaves_with_path(params_to_tree(model))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        if a.dtype == np.uint16:                        # bf16 bit views
            assert b.dtype == torch.bfloat16, path
            b = b.view(torch.int16).numpy().view(np.uint16)
        else:                   # fp32: rg's `lam`, rwkv's decay and bonus,
            # the cross-attention gates
            assert b.dtype == torch.float32 and a.dtype == np.float32, path
            b = b.numpy()
        assert np.array_equal(a, b), path


def test_ghost_heads_stay_zero():
    ref_cfg, cfg = _configs(4)
    assert cfg.num_heads_padded == 8 and cfg.num_kv_heads_padded == 2
    gen = torch.Generator().manual_seed(0)
    model = init_params(cfg, gen, "cpu")
    live = cfg.num_heads * cfg.resolved_head_dim
    for block in model.blocks:
        assert block.attn.wq.shape == (96, 8 * 16)
        assert not block.attn.wq[:, live:].any()
        assert not block.attn.wo[live:].any()
        assert block.attn.wq[:, :live].any()
    # same shapes and dtypes as the reference's init
    ref = jax.tree_util.tree_leaves(ref_abstract_params(ref_cfg))
    got = jax.tree_util.tree_leaves(params_to_tree(model))
    assert [tuple(a.shape) for a in ref] == [tuple(b.shape) for b in got]


# arch, physical parameters (every leaf), bytes, (q heads, kv heads)
# padded, and `param_count()`, which counts neither ghost heads (llama:
# 24 -> 32 q heads, 8 kv heads padded over them) nor the final norm
FULL_WIDTH = [
    ("llama3.2-3b", 3_388_910_592, 6_777_821_184, (32, 8), 3_212_746_752),
    # the 26 rg blocks' `lam` leaves (5,504 each) are fp32
    ("recurrentgemma-9b", 10_549_127_680, 21_098_541_568, (16, 1),
     10_549_123_584),
    ("phi4-mini-3.8b", 4_037_348_352, 8_074_696_704, (32, 8),
     3_836_018_688),
    # 40 q and 40 kv heads padded to 48 each: 73 GB of bf16 leaves
    ("qwen1.5-32b", 36_539_470_848, 73_078_941_696, (48, 48),
     35_196_108_800),
]


@pytest.mark.parametrize("arch,physical,nbytes,heads,counted", FULL_WIDTH)
def test_full_width_leaf_shapes_match_reference(arch, physical, nbytes,
                                                heads, counted):
    """A full-width model, without allocating it: the port builds on the
    meta device, the reference through eval_shape."""
    cfg = get_config(arch)
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config(arch)))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert all(b.dtype == torch.bfloat16 or "lam" in jax.tree_util.keystr(p)
               for p, b in got)
    assert sum(b.numel() for _, b in got) == physical
    assert sum(b.numel() * b.element_size() for _, b in got) == nbytes
    assert (cfg.num_heads_padded, cfg.num_kv_heads_padded) == heads
    assert cfg.param_count() == ref_get_config(arch).param_count() == counted
    if heads[0] == cfg.num_heads:                   # no ghost heads
        assert physical == counted + cfg.d_model


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-9b",
                                  "phi4-mini-3.8b", "qwen1.5-32b",
                                  "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
                                  "kimi-k2-1t-a32b", "rwkv6-7b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_reference_configs(smoke, arch):
    want = ref_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(want) == dataclasses.asdict(got)
    assert want.param_count() == got.param_count()


def test_unported_archs_raise_naming_the_roadmap():
    """Every reference arch is ported now (ROADMAP A9 is done): none
    raises, and an unknown name still does."""
    assert len(all_archs()) == 10
    assert set(PORTED) == set(all_archs())
    for arch in all_archs():
        assert get_config(arch).name == ref_get_config(arch).name
        assert get_config(arch, smoke=True).name == \
            ref_get_config(arch, smoke=True).name
    with pytest.raises(KeyError):
        get_config("gpt-2")


def test_serve_run_on_the_cpu():
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = serve.run(["--arch", "llama3.2-3b", "--device", "cpu",
                     "--requests", "3", "--batch", "2", "--prompt-len", "16",
                     "--gen", "4"])
    assert [t.shape for t in out["tokens"]] == [(2, 4), (1, 4)]
    assert out["served_tokens"] == 3 * (16 + 4)
    assert len(out["prefill_s"]) == len(out["decode_s"]) == 2
    # every prefill layer attends blockwise: the SMOKE head dim (16) has
    # no flash kernel, as in the reference
    assert (fak.launches, fak.plain_calls) == (0, 0)
    assert layers.blockwise_calls == 2 * 2


def test_serve_run_recurrentgemma_on_the_cpu():
    """`--arch recurrentgemma-9b` serves its SMOKE config on the CPU:
    prompts of 12 tokens over window 8 (a rolled window cache), 10 decode
    steps, running past the window; the local attention layer attends
    blockwise at head dim 16, once per prefill."""
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = serve.run(["--arch", "recurrentgemma-9b", "--device", "cpu",
                     "--requests", "3", "--batch", "2", "--prompt-len", "12",
                     "--gen", "10"])
    assert [t.shape for t in out["tokens"]] == [(2, 10), (1, 10)]
    assert out["served_tokens"] == 3 * (12 + 10)
    assert (fak.launches, fak.plain_calls) == (0, 0)
    assert layers.blockwise_calls == 2 * 1


def test_serve_default_arch_needs_mla():
    """The server's default arch, minicpm3-4b, runs MLA: its SMOKE config
    serves on the CPU, every prefill layer attending in the per-head form
    (24 + 8 and 16, zero-padded to 64) through the flash wrapper's plain
    version (16 rows a kv head: the decode route's), none blockwise; the
    decode steps attend on the absorbed latent, outside the wrapper."""
    fak.reset_counts()
    layers.reset_blockwise_calls()
    layers.reset_mla_per_head_calls()
    out = serve.run(["--device", "cpu", "--requests", "3", "--batch", "2",
                     "--prompt-len", "16", "--gen", "4"])
    assert [t.shape for t in out["tokens"]] == [(2, 4), (1, 4)]
    assert out["served_tokens"] == 3 * (16 + 4)
    assert (fak.launches, fak.plain_calls) == (0, 2 * 2)
    assert (layers.blockwise_calls, layers.mla_per_head_calls) == (0, 2 * 2)


def test_serve_is_greedy_and_deterministic():
    cfg = get_config("llama3.2-3b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    kw = dict(batch=2, requests=2, prompt_len=8, gen=3, seed=5, device="cpu")
    a = serve.serve(cfg, model, **kw)
    b = serve.serve(cfg, model, **kw)
    assert torch.equal(a["tokens"][0], b["tokens"][0])
    # the first generated token is the argmax of the prompt's last logits
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(5))
    logits, _, _ = forward(model, prompts, mode="prefill")
    assert torch.equal(a["tokens"][0][:, 0], logits[:, -1].argmax(-1))
