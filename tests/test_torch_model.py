"""The port's dense model and server against the reference, on the CPU.

The reference's `init_params(cfg, PRNGKey(0))` weights go into the port
through `params_from_jax`; the same token ids (numpy, from a seed) go
through both `forward`s. The reference runs its jnp blockwise attention on
the CPU, the port the plain version of the flash kernel (which keeps p in
fp32 for the PV product where the jnp path rounds it to bf16), and both
round every matmul to bf16: logits must agree within 5e-2 of max |logit|,
the bound `tests/test_archs.py` holds decode against train with. Measured
when this test was written: 0.0124 (train) and 0.0100 (decode) of max
|logit| at llama3.2 SMOKE, 0.0103 and 0.0061 with ghost heads.
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
from repro_torch.configs import all_archs, get_config
from repro_torch.kernels import flash_attention as fak
from repro_torch.launch import serve
from repro_torch.models import (abstract_params, forward, init_cache,
                                init_params, pad_cache_to, params_from_jax,
                                params_to_tree)

TOL = 5e-2
S = 24


def _configs(pad: int):
    """(reference, port) SMOKE configs, with ghost heads when pad > 0:
    6 q heads padded to 8 over 2 kv heads."""
    ref = ref_get_config("llama3.2-3b", smoke=True)
    port = get_config("llama3.2-3b", smoke=True)
    if pad:
        ref = dataclasses.replace(ref, name="llama3.2-ghost", tp_pad_heads=pad)
        port = dataclasses.replace(port, name="llama3.2-ghost",
                                   tp_pad_heads=pad)
    return ref, port


def _tree_numpy(params):
    """The reference tree as numpy, bf16 leaves as uint16 bit views."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), params)


@pytest.fixture(scope="module", params=[0, 4], ids=["smoke", "ghost_heads"])
def pair(request):
    ref_cfg, cfg = _configs(request.param)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = params_from_jax(cfg, _tree_numpy(params), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    return ref_cfg, cfg, params, model, tokens


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else b
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_train_logits_match(pair):
    ref_cfg, _, params, model, tokens = pair
    want, _, _ = ref_forward(params, jnp.asarray(tokens, jnp.int32), ref_cfg,
                             mode="train")
    fak.reset_counts()
    got, cache, aux = forward(model, torch.from_numpy(tokens), mode="train")
    assert cache is None and float(aux) == 0.0
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel(want, got) < TOL
    assert (fak.launches, fak.plain_calls) == (0, 2)      # one per layer


def test_prefill_and_decode_logits_match(pair):
    ref_cfg, cfg, params, model, tokens = pair
    x = jnp.asarray(tokens, jnp.int32)
    want_p, rc, _ = ref_forward(params, x[:, :S - 1], ref_cfg, mode="prefill")
    rc = ref_pad_cache_to(rc, ref_cfg, S + 4)
    want_d, _, _ = ref_forward(params, x[:, S - 1:], ref_cfg, mode="decode",
                               cache=rc, pos=jnp.int32(S - 1))
    t = torch.from_numpy(tokens)
    got_p, cache, _ = forward(model, t[:, :S - 1], mode="prefill")
    assert _rel(want_p, got_p) < TOL
    k = cache[0][0]["k"]
    assert k.shape == rc[0][0]["k"].shape[:3] + (S - 1,) + k.shape[4:]
    cache = pad_cache_to(cache, cfg, S + 4)
    assert cache[0][0]["k"].shape == rc[0][0]["k"].shape
    got_d, cache2, _ = forward(model, t[:, S - 1:], mode="decode", cache=cache,
                               pos=S - 1)
    assert cache2 is cache                        # written in place
    assert _rel(want_d, got_d) < TOL
    # the port's own decode against its train logits, as test_archs does
    got_t, _, _ = forward(model, t, mode="train")
    assert _rel(got_t[:, -1].float().numpy(), got_d[:, 0]) < TOL


def test_decode_from_a_zeroed_cache_matches_prefill(pair):
    _, cfg, _, model, tokens = pair
    t = torch.from_numpy(tokens[:, :6])
    cache = init_cache(cfg, 2, 8, device="cpu")
    for i in range(6):
        logits, cache, _ = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
    want, _, _ = forward(model, t, mode="prefill")
    assert _rel(want[:, -1].float().numpy(), logits[:, 0]) < TOL


def test_tree_round_trip_is_byte_exact(pair):
    _, _, params, model, _ = pair
    want = jax.tree_util.tree_leaves_with_path(_tree_numpy(params))
    got = jax.tree_util.tree_leaves_with_path(params_to_tree(model))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert b.dtype == torch.bfloat16, path
        assert np.array_equal(a, b.view(torch.int16).numpy().view(np.uint16))


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


def test_full_width_leaf_shapes_match_reference():
    """llama3.2-3b at full width, without allocating it: the port builds
    on the meta device, the reference through eval_shape."""
    cfg = get_config("llama3.2-3b")
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config("llama3.2-3b")))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape), "bfloat16") for p, b in got]
    assert all(b.dtype == torch.bfloat16 for _, b in got)
    physical = sum(b.numel() for _, b in got)
    assert physical == 3_388_910_592            # 6.78 GB in bf16
    assert (cfg.num_heads_padded, cfg.num_kv_heads_padded) == (32, 8)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_reference_configs(smoke):
    want = ref_get_config("llama3.2-3b", smoke=smoke)
    got = get_config("llama3.2-3b", smoke=smoke)
    assert dataclasses.asdict(want) == dataclasses.asdict(got)
    assert want.param_count() == got.param_count()


def test_unported_archs_raise_naming_the_roadmap():
    assert len(all_archs()) == 10
    for arch in all_archs():
        if arch == "llama3.2-3b":
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt-2")


def test_serve_run_on_the_cpu():
    fak.reset_counts()
    out = serve.run(["--arch", "llama3.2-3b", "--device", "cpu",
                     "--requests", "3", "--batch", "2", "--prompt-len", "16",
                     "--gen", "4"])
    assert [t.shape for t in out["tokens"]] == [(2, 4), (1, 4)]
    assert out["served_tokens"] == 3 * (16 + 4)
    assert len(out["prefill_s"]) == len(out["decode_s"]) == 2
    # flash runs in every prefill layer, as its plain version on the CPU
    assert (fak.launches, fak.plain_calls) == (0, 2 * 2)


def test_serve_default_arch_needs_mla():
    with pytest.raises(NotImplementedError, match="MLA"):
        serve.run(["--device", "cpu"])


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
