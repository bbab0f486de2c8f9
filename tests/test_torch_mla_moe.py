"""The port's `mla_moe` block kind (Kimi K2 Instruct) against the plain
float32 reference of the benchmark (`portbench/reference/mla_moe.py`),
on the CPU, at SMOKE widths on weights drawn from a seed. No JAX: the
reference package has no such block.

The weights are drawn in the published layout (`portbench.inputs.Weights`)
and go into the port through the benchmark's loader
(`portbench.program.build`, `blocks/mla_moe.load`). Tolerances:

- the model's logits and latent cache against the reference's, prefill
  and four decode steps through the cache, every leaf in fp32 in the
  port: 1e-5 of max |value| (the same arithmetic in another order;
  measured when this test was written: at most 2.3e-7). The reference in
  fp8 (its control) lies further off than 1e-2 (measured: 0.038-0.043),
  which each prefill case asserts;
- the dropless layer against its sum written out: 1e-5 (measured
  1.8e-7); the router's weights: 1e-6 relative (fp32 division of the
  same scores); its choices, the YaRN table's split and the tie order:
  exact;
- the held experts' shares against the uncut layer: 1e-5 of max |out|
  (fp32 sums in another order; measured: at most 5.1e-8);
- replay: bit for bit (bf16, as served).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import program  # noqa: E402
from portbench.blocks import mla_moe as block_kind  # noqa: E402
from portbench.inputs import Weights  # noqa: E402
from portbench.reference import mla_moe as ref  # noqa: E402
from portbench.reference.model import Forward  # noqa: E402
from portbench.reference.precision import FP8, FP32  # noqa: E402
from repro_torch.configs import PORT_ONLY, all_archs, get_config  # noqa: E402
from repro_torch.models import forward, layers, pad_cache_to  # noqa: E402
from repro_torch.models.config import RoutedMoEConfig  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5
FP8_OFF = 1e-2
ARCH = "kimi-k2-instruct-ep32"
PUBLISHED = ROOT / "portbench" / "configs" / "kimi-k2-instruct-ep32-30l.json"


def _config(held: int = 4, first: int = 0) -> dict:
    """The benchmark's configuration of the cell at the port's SMOKE
    widths (2 layers): `held` of 16 experts, from `first`."""
    import json
    cfg = json.loads(PUBLISHED.read_text())
    smoke = get_config(ARCH, smoke=True)
    m, a = smoke.moe, smoke.mla
    c = copy.deepcopy(cfg["config"])
    c.update({"hidden_size": smoke.d_model, "num_attention_heads":
              smoke.num_heads, "num_key_value_heads": smoke.num_kv_heads,
              "q_lora_rank": a.q_lora_rank, "kv_lora_rank": a.kv_lora_rank,
              "qk_nope_head_dim": a.qk_nope_head_dim,
              "qk_rope_head_dim": a.qk_rope_head_dim,
              "v_head_dim": a.v_head_dim, "intermediate_size": smoke.d_ff,
              "moe_intermediate_size": m.d_ff_expert,
              "n_routed_experts": held, "first_held_expert": first,
              "router_experts": m.num_experts,
              "num_experts_per_tok": m.num_experts_per_tok,
              "vocab_size": smoke.vocab_size})
    c["rope_scaling"] = {**c["rope_scaling"],
                         "original_max_position_embeddings":
                         a.original_max_position}
    return {**cfg, "config": c, "smoke": True, "layers": 2}


def _model(config: dict, seed: int = 11):
    """(weights, the port's model holding them, in fp32): the benchmark's
    `program.build`, with the port's SMOKE arch holding the configuration's
    experts."""
    w, c = Weights(config, seed, CPU), config["config"]
    cfg = program.port_config(config)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, held=c["n_routed_experts"],
        first_held=c["first_held_expert"]))
    block_kind.check_port(cfg, c)
    model = program._port().models.Transformer(cfg, None, "meta")
    for li, block in enumerate(model.blocks):
        block_kind.load(block, w.layer(li), cfg, c)
    for name, leaf in w.top.items():
        setattr(model, name, torch.nn.Parameter(leaf, requires_grad=False))
    return w, model.float()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_kimi_archs_are_the_ports_own():
    """Both archs resolve through `get_config`, outside the reference's
    ten; the whole model has its published size (1.03 T parameters, 32.9 B
    active) and a leading dense layer; the EP32 share holds 12 experts."""
    assert set(PORT_ONLY) == {"kimi-k2-instruct", ARCH}
    assert not set(PORT_ONLY) & set(all_archs())
    full, ep = get_config("kimi-k2-instruct"), get_config(ARCH)
    assert [s.blocks for s in full.segments] == [("mla",), ("mla_moe",)]
    assert (full.num_layers, full.d_ff, full.moe.held_experts) == \
        (61, 18432, 384)
    assert full.param_count() == 1_026_408_100_352
    assert full.active_param_count() == 32_861_368_832
    assert (ep.num_layers, ep.moe.held_experts, ep.moe.first_held) == \
        (60, 12, 0)
    assert ep.moe.num_experts == 384 and ep.moe.routed_scale == 2.827


@pytest.mark.parametrize("held,first", [(4, 0), (4, 12), (16, 0)])
def test_prefill_logits_and_cache_match_the_reference(held, first):
    config = _config(held, first)
    w, model = _model(config)
    tokens = torch.randint(0, 512, (2, 40),
                           generator=torch.Generator().manual_seed(3))
    layers.reset_mla_per_head_calls()
    layers.reset_blockwise_calls()
    logits, cache, _ = forward(model, tokens, mode="prefill")
    assert (layers.mla_per_head_calls, layers.blockwise_calls) == (2, 0)
    want = Forward(config, w, tokens, FP32)
    for li, got_cache, _, _ in want:
        for name, r in got_cache.items():
            assert _rel(cache[0][0][name][li], r) < TOL, (li, name)
    assert _rel(logits[:, -1], want.logits) < TOL
    control = Forward(config, w, tokens, FP8)
    for _ in control:
        pass
    assert _rel(control.logits, want.logits) > FP8_OFF


def test_decode_through_the_cache_follows_the_full_forward():
    """Prefill of 36 tokens, then 4 decode steps (absorbed MLA, YaRN at
    each position) against the reference's forward over each prefix."""
    config = _config()
    w, model = _model(config)
    tokens = torch.randint(0, 512, (2, 40),
                           generator=torch.Generator().manual_seed(4))
    _, cache, _ = forward(model, tokens[:, :36], mode="prefill")
    cache = pad_cache_to(cache, model.cfg, 40)
    for i in range(36, 40):
        got, cache, _ = forward(model, tokens[:, i:i + 1], mode="decode",
                                cache=cache, pos=i)
        want = Forward(config, w, tokens[:, :i + 1], FP32)
        for _ in want:
            pass
        assert _rel(got[:, 0], want.logits) < TOL, i


def _route(scores_logit: torch.Tensor, bias: torch.Tensor | None, k: int):
    """`_route_scores` on x = the identity, the router `scores_logit`'s
    columns: each token's logits are its row (no bias: zeros)."""
    e = scores_logit.shape[-1]
    m = RoutedMoEConfig(num_experts=e, num_experts_per_tok=k, d_ff_expert=8,
                        routed_scale=2.827)
    x = torch.eye(scores_logit.shape[0])[None]
    return layers._route_scores(
        x, scores_logit, torch.zeros(e) if bias is None else bias, m)


def test_router_bias_chooses_and_does_not_weigh():
    """The bias moves expert 3 above expert 2 for the choice; the weights
    are the sigmoid scores of the chosen experts over their sum, x 2.827,
    with or without the bias."""
    z = torch.tensor([[2.0, 1.0, 0.5, 0.4, -1.0, -2.0]])
    s = torch.sigmoid(z)[0]
    _, w0, t0 = _route(z, None, 3)
    bias = torch.tensor([0.0, 0.0, 0.0, 0.05, 0.0, 0.0])
    _, w1, t1 = _route(z, bias, 3)
    assert t0[0, 0].tolist() == [0, 1, 2] and t1[0, 0].tolist() == [0, 1, 3]
    for w, chosen in ((w0, [0, 1, 2]), (w1, [0, 1, 3])):
        want = s[chosen] / s[chosen].sum() * 2.827
        assert torch.allclose(w[0, 0], want, rtol=1e-6, atol=0)
        assert float(w[0, 0].sum()) == pytest.approx(2.827, rel=1e-6)


def test_router_scores_in_fp32_from_a_bf16_input():
    """The scores are the sigmoid of the fp32 product of the bf16 input
    and the fp32 router, and the weights come from those fp32 scores (a
    bf16 product would move them by about 1e-2)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 32, generator=g).bfloat16()
    router = torch.randn(32, 16, generator=g)
    m = RoutedMoEConfig(num_experts=16, num_experts_per_tok=4,
                        d_ff_expert=8, routed_scale=2.827)
    scores, w, topi = layers._route_scores(x, router, torch.zeros(16), m)
    want = torch.sigmoid(x.float() @ router)
    assert scores.dtype == w.dtype == torch.float32
    assert torch.equal(scores, want)
    chosen = want.gather(-1, topi)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * 2.827,
                          rtol=1e-6, atol=0)


def test_router_ties_in_index_order_and_unnormalised_weights():
    """A zero router ties every score at 0.5: the chosen experts are the
    first K in index order, and each weight is its score over the chosen
    scores' sum x the scale, 2.827 / 4 (the renormalisation is fixed
    behaviour of the dropless route)."""
    z = torch.zeros(3, 8)
    _, w, topi = _route(z, torch.zeros(8), 4)
    assert topi[0].tolist() == [[0, 1, 2, 3]] * 3
    assert torch.allclose(w, torch.full_like(w, 2.827 / 4), rtol=1e-6)


def test_dropless_every_choice_to_a_held_expert_is_computed():
    """Every token chooses the same 4 held experts (a bias of 10 on
    them): each of the 64 tokens x 4 choices runs (`rows` 256, 64 an
    expert), and the output is each token's weighted sum over them, in
    fp32, with nothing dropped; with no choice held, zeros."""
    cfg = get_config(ARCH, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, held=4, first_held=8, num_shared_experts=0))
    mod = layers.MoE(cfg, torch.Generator().manual_seed(5), "cpu").float()
    mod.correction_bias.data[:] = 0.0
    mod.correction_bias.data[8:12] = 10.0
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    from repro_torch import obs
    with obs.recording() as rec:
        out, _ = layers.moe_ffn(mod, x, cfg)
    dispatch = [s for s in rec.spans() if s.name == "moe.dispatch"]
    assert [(s.attrs["rows"], s.attrs["rows_max"], s.attrs["held"])
            for s in dispatch] == [(256, 64, 4)]
    s = torch.sigmoid(x @ mod.router)
    w = s[..., 8:12] / s[..., 8:12].sum(-1, keepdim=True) * 2.827
    want = torch.zeros_like(x)
    for j in range(4):
        h = torch.nn.functional.silu(x @ mod.w_gate[j]) * (x @ mod.w_up[j])
        want += w[..., j:j + 1] * (h @ mod.w_down[j])
    assert _rel(out, want) < TOL
    # no choice held (a decode step's usual case): nothing to compute
    mod.correction_bias.data[8:12] = -10.0
    out, _ = layers.moe_ffn(mod, x, cfg)
    assert not out.any()


def test_yarn_table_is_the_formula():
    """At the published values (r 64, theta 50,000, s 32, L0 4,096, both
    betas 1): c(1) = 19.16, low 19, high 20, so pairs 0-19 keep f_i and
    20-31 take f_i / 32; the factor is 1 and the softmax scale 192^-1/2 x
    1.34657^2. The port's table is the reference's, in fp32."""
    a = get_config(ARCH).mla
    c = 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000))
    assert (math.floor(c), math.ceil(c)) == (19, 20)
    inv, factor = layers.yarn_freqs(64, 50000.0, a, CPU)
    f = 1.0 / 50000.0 ** (torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    want = torch.cat([f[:20], f[20:] / 32])
    assert torch.equal(inv, want.float()) and factor == 1.0
    import json
    c_pub = json.loads(PUBLISHED.read_text())["config"]
    ref_inv, ref_factor = ref.yarn(c_pub, CPU)
    assert torch.allclose(ref_inv, want, rtol=1e-14, atol=0)
    assert ref_factor == 1.0
    g = 0.1 * math.log(32) + 1
    assert g == pytest.approx(1.34657, abs=1e-5)
    assert layers.mla_softmax_scale(a) == pytest.approx(192 ** -0.5 * g * g,
                                                        rel=1e-12)
    assert ref.softmax_scale(c_pub) == layers.mla_softmax_scale(a)
    # plain RoPE stays the default: minicpm3's scale is qk^-1/2 exactly
    assert layers.mla_softmax_scale(get_config("minicpm3-4b").mla) == \
        96 ** -0.5


def test_replay_is_bit_for_bit():
    """Two bf16 prefills of the same prompts, as served: the same bits in
    the logits and every cache leaf (the combine adds in a fixed order)."""
    config = _config()
    model, prefill = program.build(config, Weights(config, 12, CPU), CPU)
    tokens = torch.randint(0, 512, (3, 48),
                           generator=torch.Generator().manual_seed(7))
    (a, ca), (b, cb) = prefill(model, tokens), prefill(model, tokens)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for name in ca[0][0]:
        assert torch.equal(ca[0][0][name].view(torch.int16),
                           cb[0][0][name].view(torch.int16))


def test_the_shares_add_up_to_the_uncut_layer():
    """Four chips' shares of the 16 SMOKE experts (4 each, from 0, 4, 8,
    12): the routed parts of their `moe_ffn` outputs, with the shared
    expert (which every chip computes alike) counted once, add up to the
    reference's uncut MoE (all 16 experts held)."""
    whole = _config(16, 0)
    w = Weights(whole, 13, CPU).layer(0)
    h = torch.randn(2, 24, whole["config"]["hidden_size"],
                    generator=torch.Generator().manual_seed(8))
    want, _, _ = ref.moe(h, w, whole["config"], FP32)
    smoke = get_config(ARCH, smoke=True)
    total, shared = 0.0, None
    for first in (0, 4, 8, 12):
        cfg = dataclasses.replace(smoke, moe=dataclasses.replace(
            smoke.moe, held=4, first_held=first))
        mod = layers.MoE(cfg, None, "cpu")
        par = torch.nn.Parameter
        for name, leaf in (("router", w["router"]),
                           ("correction_bias", w["correction_bias"]),
                           ("w_gate", w["w1"][first:first + 4]),
                           ("w_up", w["w3"][first:first + 4]),
                           ("w_down", w["w2"][first:first + 4])):
            setattr(mod, name, par(leaf.float(), requires_grad=False))
        for name, leaf in (("w_gate", "shared_w1"), ("w_up", "shared_w3"),
                           ("w_down", "shared_w2")):
            setattr(mod.shared, name, par(w[leaf].float(),
                                          requires_grad=False))
        out, _ = layers.moe_ffn(mod, h, cfg)
        shared = mod.shared(h)
        total = total + (out - shared)
    assert _rel(total + shared, want) < TOL


def test_grouped_experts_equal_the_plain_loop():
    """`torch._grouped_mm` (the card's route) over rows grouped by expert,
    one group empty, equals the plain per-expert loop bit for bit on the
    CPU."""
    g = torch.Generator().manual_seed(9)
    sizes = [5, 0, 9, 3]
    xs = torch.randn(sum(sizes), 32, generator=g).bfloat16()
    wg, wu = (torch.randn(4, 32, 16, generator=g).bfloat16()
              for _ in range(2))
    wd = torch.randn(4, 16, 32, generator=g).bfloat16()
    offs = torch.tensor(sizes).cumsum(0).to(torch.int32)
    gate = torch._grouped_mm(xs, wg, offs=offs)
    act = torch.nn.functional.silu(gate.float()).bfloat16() * \
        torch._grouped_mm(xs, wu, offs=offs)
    grouped = torch._grouped_mm(act, wd, offs=offs)
    plain = layers._expert_ffn_plain(xs, wg, wu, wd, sizes)
    assert torch.equal(grouped, plain)


def test_the_kind_has_no_mesh_path():
    """The dropless MoE, the kind's feed-forward, refuses a device mesh
    (the one guard: `moe_ffn`)."""
    cfg = get_config(ARCH, smoke=True)
    mod = layers.MoE(cfg, None, "meta")
    with pytest.raises(NotImplementedError, match="mesh"):
        layers.moe_ffn(mod, torch.zeros(1, 2, cfg.d_model, device="meta"),
                       cfg, mesh=object())


def test_aux_only_in_train_mode():
    """The dropless layer computes its load-balance loss only in train
    mode: a model's prefill sums none (0), a train forward a positive
    one, and the logits are the same bits either way."""
    cfg = get_config(ARCH, smoke=True)
    model = program._port().models.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        pre, _, aux_pre = forward(model, tokens, mode="prefill")
        tr, _, aux_tr = forward(model, tokens, mode="train")
    assert float(aux_pre) == 0.0 and float(aux_tr) > 0.0
    assert torch.equal(pre.view(torch.int16), tr.view(torch.int16))
