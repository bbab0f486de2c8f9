"""The port's MoE FFN (`attn_moe`: phi3.5-moe, kimi-k2) against the
reference, on the CPU.

The reference's weights (`init_moe`, `init_params` with PRNGKey(0)) go
into the port through `params_from_jax`; the same inputs (numpy, from a
seed) go through both. Routing is where the two could part: `torch.topk`
orders equal values otherwise than `jax.lax.top_k`, and `moe_ffn`'s
capacity step ranks every token an expert did not choose at -1, all tied.
The port's `top_k` is a stable descending sort, which orders ties as jax
does; the cases below tie on purpose (a zero router: every probability
equal; duplicated router columns: equal routing weights) and drop tokens
(a capacity under the tokens' share). A different choice of expert or of
kept token moves a token's output by the size of an expert's output, so
the output bound pins the choices. Tolerances:

- `moe_ffn`'s output: 2e-2 of max |out| (bf16 matmuls round in other
  places; measured when this test was written: at most 2.6e-4); aux: 1e-6
  relative (fp32 statistics of the same choices; measured: equal);
- the models' logits and aux against the reference's, train, prefill and
  every decode step, with every leaf in fp32 in both packages: 1e-4 of
  max |logit| and 1e-5 relative (measured: at most 1.2e-6 and 1.0e-7);
  in bf16, as served, the train logits and the port's decode against its
  prefill: 5e-2 of max |logit|, as `tests/test_torch_model.py` (measured:
  at most 1.3e-2);
- `moe_capacity` and the tie order: exact;
- `loss_fn`'s loss against nll + the config's `router_aux_weight` x aux:
  1e-6 relative; `chip_smoke.py`'s routing probe and its root switches
  (phase 14's bf16 check): exact, on made-up records and on a SMOKE model.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import MoEConfig as RefMoEConfig
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import pad_cache_to as ref_pad_cache_to
from repro_torch.configs import get_config
from repro_torch.models import (MoEConfig, abstract_params, forward,
                                init_params, layers, pad_cache_to,
                                params_from_jax, params_to_tree)

OUT_TOL = 2e-2
AUX_TOL = 1e-6
TOL = 5e-2
FP32_TOL = 1e-4
FP32_AUX_TOL = 1e-5
S = 24


def _host(tree):
    """A reference tree as numpy, bf16 leaves as uint16 bit views."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), tree)


def _rel(want, got) -> float:
    a = np.asarray(want, np.float32)
    b = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _as_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# the tie rule and the capacity
# ---------------------------------------------------------------------------

def test_top_k_orders_ties_as_jax():
    v = [-1.0, 5.0, -1.0, 5.0, -1.0, -1.0, 2.0, -1.0, -1.0, -1.0]
    _, want = jax.lax.top_k(jnp.asarray(v, jnp.float32), 6)
    vals, got = layers.top_k(torch.tensor(v), 6)
    assert got.tolist() == np.asarray(want).tolist() == [1, 3, 6, 0, 2, 4]
    assert vals.tolist() == [5.0, 5.0, 2.0, -1.0, -1.0, -1.0]
    # on a batch of rows, along the last axis only
    rows = np.random.default_rng(0).integers(0, 3, (5, 4, 17)).astype(
        np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(rows), 9)
    gv, gi = layers.top_k(torch.from_numpy(rows), 9)
    assert np.array_equal(np.asarray(wi), gi.numpy())
    assert np.array_equal(np.asarray(wv), gv.numpy())


@pytest.mark.parametrize("experts,k,factor", [
    (16, 2, 1.25), (384, 8, 1.25), (4, 2, 1.0), (8, 2, 8.0), (4, 2, 0.5),
    (64, 6, 1.0)])
def test_moe_capacity_is_the_references(experts, k, factor):
    m = MoEConfig(num_experts=experts, num_experts_per_tok=k,
                  capacity_factor=factor)
    ref = RefMoEConfig(num_experts=experts, num_experts_per_tok=k,
                       capacity_factor=factor)
    for tokens in (1, 2, 7, 8, 9, 24, 32, 100, 2047, 2048, 4096):
        assert layers.moe_capacity(m, tokens) == \
            RL.moe_capacity(ref, tokens), tokens


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _moe_pair(arch, router="random", **moe_changes):
    """(reference config, port config, reference moe params of layer 0, the
    port's MoE module holding the same weights). `router`: "random" (the
    init's), "zero" (every probability tied), or "tied" (each odd expert's
    column a copy of the even one before it: equal weights)."""
    ref = ref_get_config(arch, smoke=True)
    port = get_config(arch, smoke=True)
    if moe_changes:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(
            ref.moe, **moe_changes))
        port = dataclasses.replace(port, moe=dataclasses.replace(
            port.moe, **moe_changes))
    p = RL.init_moe(jax.random.PRNGKey(3), ref)
    if router == "zero":
        p["router"] = jnp.zeros_like(p["router"])
    elif router == "tied":
        p["router"] = p["router"].at[:, 1::2].set(p["router"][:, 0::2])
    mod = layers.MoE(port, device="cpu")
    for name, param in mod.named_parameters():
        leaf = p
        for key in name.split("."):
            leaf = leaf[key]
        param.data.copy_(_as_tensor(leaf))
    return ref, port, p, mod


# arch, router, moe config changes
MOE_CASES = {
    "phi_random": ("phi3.5-moe-42b-a6.6b", "random", {}),
    "phi_zero_router": ("phi3.5-moe-42b-a6.6b", "zero", {}),
    "phi_tied_weights": ("phi3.5-moe-42b-a6.6b", "tied", {}),
    "phi_drops": ("phi3.5-moe-42b-a6.6b", "random", {"capacity_factor": 0.5}),
    "phi_tied_drops": ("phi3.5-moe-42b-a6.6b", "tied",
                       {"capacity_factor": 0.5}),
    "kimi_random": ("kimi-k2-1t-a32b", "random", {}),
    "kimi_zero_drops": ("kimi-k2-1t-a32b", "zero", {"capacity_factor": 1.0}),
    "shared_expert": ("kimi-k2-1t-a32b", "random",
                      {"num_shared_experts": 1, "d_ff_shared": 32}),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    arch, router, changes = MOE_CASES[case]
    ref_cfg, cfg, p, mod = _moe_pair(arch, router, **changes)
    rows = 32
    x = np.random.default_rng(5).normal(size=(2, rows, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    want, waux = RL.moe_ffn(p, xj, ref_cfg)
    with torch.inference_mode():
        got, aux = layers.moe_ffn(mod, xt, cfg)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert aux.dtype == torch.float32
    assert _rel(want, got) < OUT_TOL
    assert abs(float(aux) - float(waux)) <= AUX_TOL * abs(float(waux))
    if "drops" in case:
        # some (row, expert) is chosen by more tokens than it keeps
        probs = torch.softmax(xt.float() @ mod.router.detach(), dim=-1)
        _, topi = layers.top_k(probs, cfg.moe.num_experts_per_tok)
        chosen = torch.nn.functional.one_hot(
            topi, cfg.moe.num_experts).sum(dim=(1, 2))       # (B, E)
        assert int(chosen.max()) > layers.moe_capacity(cfg.moe, rows)
    if router == "zero":
        # every probability 1/E, every token picks experts 0..K-1 (ties in
        # index order): aux = E * K * (1/K) * (1/E) = 1
        assert float(aux) == pytest.approx(1.0, rel=1e-6)


def test_moe_combine_is_deterministic_and_has_no_atomics():
    """Two runs give the same bits; a token's output is the sum of its
    kept experts' weighted outputs, added in expert order."""
    _, cfg, _, mod = _moe_pair("kimi-k2-1t-a32b", "random")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        a, _ = layers.moe_ffn(mod, x, cfg)
        b, _ = layers.moe_ffn(mod, x, cfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_moe_gradients_flow_to_router_and_experts():
    _, cfg, _, mod = _moe_pair("phi3.5-moe-42b-a6.6b", "random")
    mod.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    out, aux = layers.moe_ffn(mod, x, cfg)
    (out.float().square().mean() + 0.01 * aux).backward()
    for name, param in mod.named_parameters():
        assert param.grad is not None and param.grad.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    ref_cfg = ref_get_config(request.param, smoke=True)
    cfg = get_config(request.param, smoke=True)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = params_from_jax(cfg, _host(params), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    return ref_cfg, cfg, params, model, tokens


def test_model_logits_and_aux_match_reference(pair):
    """Train logits and aux; a prefill of S - 4 tokens and four decode
    steps, each step's logits and aux against the reference's. Every leaf
    in fp32 in both packages (as `tests/test_torch_train.py` compares the
    same arithmetic without bf16 rounding): routing is discontinuous, and
    in bf16 the two packages' activations differ by a rounding, which
    switches the expert of a token whose router probabilities nearly tie
    (phi3.5-moe SMOKE, a prefill of 20 tokens: layer 1, token 9, experts
    1 and 3 at 0.24335 and 0.24153 in the reference, reversed in the port;
    0.21 of max |logit| at that token). On the same bf16 inputs the
    layer's choices are the reference's (`test_moe_ffn_matches_reference`)
    and the bf16 model's gradients are held in `tests/test_torch_train.py`."""
    ref_cfg, cfg, params, model, tokens = pair
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    model = copy.deepcopy(model).float()          # the fixture's stays bf16
    x = jnp.asarray(tokens, jnp.int32)
    t = torch.from_numpy(tokens)
    want, _, waux = ref_forward(params, x, ref_cfg, mode="train")
    layers.reset_blockwise_calls()
    got, _, aux = forward(model, t, mode="train")
    assert layers.blockwise_calls == cfg.num_layers      # head dim 16
    assert got.dtype == torch.float32
    assert _rel(want, got) < FP32_TOL
    assert float(waux) > 0
    assert abs(float(aux) - float(waux)) <= FP32_AUX_TOL * float(waux)
    P = S - 4
    wp, rc, wpaux = ref_forward(params, x[:, :P], ref_cfg, mode="prefill")
    gp, cache, gpaux = forward(model, t[:, :P], mode="prefill")
    assert _rel(wp, gp) < FP32_TOL
    assert abs(float(gpaux) - float(wpaux)) <= FP32_AUX_TOL * float(wpaux)
    rc = ref_pad_cache_to(rc, ref_cfg, S + 2)
    cache = pad_cache_to(cache, cfg, S + 2)
    assert [tuple(v.shape) for v in cache[0][0].values()] == \
        [v.shape for v in rc[0][0].values()]
    for i in range(P, S):
        wd, rc, wdaux = ref_forward(params, x[:, i:i + 1], ref_cfg,
                                    mode="decode", cache=rc,
                                    pos=jnp.int32(i))
        gd, cache, gdaux = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
        assert _rel(wd, gd) < FP32_TOL, i
        assert abs(float(gdaux) - float(wdaux)) <= \
            FP32_AUX_TOL * float(wdaux), i


def test_bf16_model_serves_and_decode_follows_prefill(pair):
    """As served, in bf16: prefill + decode steps of the port against its
    own prefill at each next position, at a length the capacity keeps
    whole (C == S: no token dropped, so a decode step and a prefill route
    alike), within 5e-2 of max |logit|; the train logits against the
    reference's within the same bound."""
    ref_cfg, cfg, params, model, tokens = pair
    n = 8
    assert layers.moe_capacity(cfg.moe, n) == n
    t = torch.from_numpy(tokens[:, :n])
    full, _, _ = forward(model, t, mode="prefill")
    _, cache, _ = forward(model, t[:, :n - 3], mode="prefill")
    cache = pad_cache_to(cache, cfg, n)
    for i in range(n - 3, n):
        step, cache, aux = forward(model, t[:, i:i + 1], mode="decode",
                                   cache=cache, pos=i)
        assert step.dtype == torch.bfloat16 and float(aux) > 0
        assert _rel(full[:, i].float().numpy(), step[:, 0]) < TOL, i
    want, _, _ = ref_forward(params, jnp.asarray(tokens[:, :n], jnp.int32),
                             ref_cfg, mode="train")
    got, _, _ = forward(model, t, mode="train")
    assert _rel(want, got) < TOL


def test_tree_round_trip_is_byte_exact(pair):
    """The reference's tree, router fp32 among bf16 experts, byte for
    byte."""
    _, _, params, model, _ = pair
    want = jax.tree_util.tree_leaves_with_path(_host(params))
    got = jax.tree_util.tree_leaves_with_path(params_to_tree(model))
    assert [p for p, _ in want] == [p for p, _ in got]
    names = set()
    for (path, a), (_, b) in zip(want, got):
        name = jax.tree_util.keystr(path)
        names.add(name.split("[")[-1])
        if "router" in name:
            assert a.dtype == np.float32 and b.dtype == torch.float32
            assert np.array_equal(a, b.numpy()), name
        else:
            assert b.dtype == torch.bfloat16, name
            assert np.array_equal(a, b.view(torch.int16).numpy().view(
                np.uint16)), name
    assert {"'router']", "'w_gate']", "'w_up']", "'w_down']"} <= names


def test_shared_expert_tree_is_the_references():
    """`num_shared_experts` adds a `moe/shared` SwiGLU, at the reference's
    paths and shapes."""
    ref_cfg = ref_get_config("kimi-k2-1t-a32b", smoke=True)
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, num_shared_experts=2, d_ff_shared=16))
    cfg = get_config("kimi-k2-1t-a32b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_shared_experts=2, d_ff_shared=16))
    want = jax.tree_util.tree_leaves_with_path(ref_abstract_params(ref_cfg))
    got = jax.tree_util.tree_leaves_with_path(params_to_tree(init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in want] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert any("shared" in jax.tree_util.keystr(p) for p, _ in got)


# arch, physical parameters, bytes (router fp32), `param_count()`
FULL_WIDTH = [
    ("phi3.5-moe-42b-a6.6b", 41_872_527_360, 83_749_249_024,
     41_872_523_264),
    ("kimi-k2-1t-a32b", 1_041_166_988_288, 2_082_669_783_040,
     1_041_166_981_120),
]


@pytest.mark.parametrize("arch,physical,nbytes,counted", FULL_WIDTH)
def test_full_width_moe_matches_the_reference_layout(arch, physical, nbytes,
                                                     counted):
    """At full width on the meta device: the reference's leaves, shapes
    and dtypes (the router fp32), without allocating."""
    cfg = get_config(arch)
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config(arch)))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert sum(b.numel() for _, b in got) == physical
    assert sum(b.numel() * b.element_size() for _, b in got) == nbytes
    assert cfg.param_count() == counted


# ---------------------------------------------------------------------------
# the loss's aux weight, and chip_smoke.py's routing probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight", [0.01, 0.5])
def test_loss_weighs_aux_by_the_moe_config(weight):
    """`loss_fn` adds the MoE config's `router_aux_weight` x aux to the
    nll (1e-6 relative: the same fp32 sum); a config without MoE trains
    on the nll alone."""
    from repro_torch.train import loss_fn
    base = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, router_aux_weight=weight))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, S)))
    with torch.no_grad():
        loss, (nll, aux) = loss_fn(model, tokens, tokens.roll(-1, 1))
    assert float(aux) > 0
    want = float(nll) + weight * float(aux)
    assert abs(float(loss) - want) <= 1e-6 * want
    dense = init_params(get_config("llama3.2-3b", smoke=True),
                        torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        loss, (nll, aux) = loss_fn(dense, tokens % 256, tokens.roll(-1, 1)
                                   % 256)
    assert float(aux) == 0.0 and float(loss) == float(nll)


def _chip_smoke():
    """`chip_smoke.py` from the repo root, as a module (its top level
    imports only the standard library)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_routing_probe_sees_every_moe_call_and_no_switch_on_one_device():
    """Phase 14's probe around the decode check's three forwards (prefill
    of P, prefill of P - 1, one decode step) at phi3.5-moe SMOKE with
    the capacity at the row: 3 x L records, `moe_ffn` restored after,
    and on one device, in fp32, no routing switch between the paths."""
    cs = _chip_smoke()
    base = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.num_experts
        / base.moe.num_experts_per_tok))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.float()
    B, P = 3, S
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, P)))
    inner = layers.moe_ffn
    with cs.routing_probe() as calls:
        forward(model, prompts, mode="prefill")
        _, cache, _ = forward(model, prompts[:, :P - 1], mode="prefill")
        cache = pad_cache_to(cache, cfg, P + 2)
        forward(model, prompts[:, P - 1:], mode="decode", cache=cache,
                pos=P - 1)
    assert layers.moe_ffn is inner
    assert len(calls) == 3 * cfg.num_layers
    assert cs.routing_switches(calls, cfg.num_layers, P, B) == []


def _records(sets, z=None, x=None, router=None):
    """One `routing_probe` record: sets (B, S, K) and the router's view."""
    sets = torch.tensor(sets)
    B, T, _ = sets.shape
    return dict(sets=sets, z=torch.zeros(B, T, 3) if z is None else z,
                x=torch.zeros(B, T, 4) if x is None else x,
                router=torch.zeros(4, 3) if router is None else router)


@pytest.mark.parametrize("gap,near_tie", [(0.001, True), (0.5, False)])
def test_routing_switches_lists_root_switches_with_their_gap(gap, near_tie):
    """Two layers, two sequences of P = 2 tokens, K = 1 of 3 experts.
    Sequence 0 switches at (layer 0, token 1) and, as a consequence, at
    (layer 1, token 1): one root. Sequence 1 switches at (layer 1, token
    0) only: a root. The gap is path A's logit of the lost expert minus
    the added one's; the bound is 2^-8 x sum_k |x_k| |w_k,lost -
    w_k,added| = 2^-8 x 4 x 1 here (exact)."""
    cs = _chip_smoke()
    z = torch.zeros(2, 2, 3)
    z[0, 1] = torch.tensor([1.0, 1.0 - gap, 0.0])
    z[1, 0] = torch.tensor([1.0, 1.0 - gap, 0.0])
    x = torch.ones(2, 2, 4)
    router = torch.zeros(4, 3)
    router[:, 0] = 1.0
    a0 = _records([[[0], [0]], [[0], [0]]], z, x, router)
    a1 = _records([[[0], [0]], [[0], [0]]], z, x, router)
    b0 = _records([[[0]], [[0]]])            # prefill of P - 1
    b1 = _records([[[0]], [[1]]])
    d0 = _records([[[1]], [[0]]])            # the decode step
    d1 = _records([[[2]], [[0]]])
    got = cs.routing_switches([a0, a1, b0, b1, d0, d1], 2, 2, 2)
    bound = 4 * 2.0 ** -8
    assert got == [
        dict(seq=0, layer=0, token=1, gap=round(gap, 6),
             bound=round(bound, 6), near_tie=near_tie),
        dict(seq=1, layer=1, token=0, gap=round(gap, 6),
             bound=round(bound, 6), near_tie=near_tie)]
