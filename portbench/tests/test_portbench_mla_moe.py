"""The `mla_moe` cell's pieces (Kimi K2 Instruct, one EP32 chip's share):
its leaves and how they go into the port, its work counts, its three
span readers, and its limits, which a small stand-in of the cell (the
block kind at the port's SMOKE widths, the harness as it runs) passes
unbroken and fails broken."""
from __future__ import annotations

import copy
import itertools
import time

import pytest
import torch
from portbench_cases import ROOT  # noqa: F401  (puts the port on the path)
from test_portbench_faults import altered, half, stale, tail
from test_portbench_spans import Span

from portbench import check, harness, program, spans, spec, workcount
from portbench.blocks import mla_moe
from portbench.inputs import Prompts, Weights

CPU = torch.device("cpu")
CELL = "kimi-k2-instruct-ep32-30l.prefill-4k"
READERS = ["moe_grouped_roofline.prefill", "moe_route_share.prefill",
           "moe_shared_share.prefill"]


def _stand_in() -> spec.Spec:
    """The cell with its configuration at the port's SMOKE widths (4
    layers, 4 of 16 experts held), 2 x 64 tokens a batch; its limits as
    they are. The shared expert's down projection is drawn at N(0,
    1/fan-in), not the cell's x 0.35: the limits are set from 30 layers at
    full width, whose bf16 error is about 4 times the stand-in's, and at
    x 0.35 four small layers without the shared expert move the cache by
    no more than that (cache_err 0.035); at N(0, 1/fan-in) by 0.10."""
    sp = spec.load(CELL)
    c = copy.deepcopy(sp.config["config"])
    c.update({"hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 4, "q_lora_rank": 32, "kv_lora_rank": 24,
              "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
              "intermediate_size": 96, "moe_intermediate_size": 32,
              "n_routed_experts": 4, "router_experts": 16,
              "num_experts_per_tok": 4, "vocab_size": 512})
    c["rope_scaling"] = {**c["rope_scaling"],
                         "original_max_position_embeddings": 16}
    sp.config = {**sp.config, "config": c, "smoke": True, "layers": 4,
                 "draw_scale": {**sp.config["draw_scale"], "shared_w2": 1.0}}
    sp.traffic = {**sp.traffic, "batch": 2, "prompt_len": 64,
                  "warmup_batches": 1}
    return sp


def test_leaves_go_into_the_port_and_back():
    """Every leaf lands in the port's block as it was drawn (the router and
    its bias float32, the held experts and the shared expert bf16), and
    the per-head absorptions the loader derives give back `kv_b`."""
    sp = _stand_in()
    c = sp.config["config"]
    w = Weights(sp.config, 3, CPU)
    model, _ = program.build(sp.config, w, CPU)
    assert [n for n, *_ in mla_moe.leaves(c)] == [
        "norm1", "q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "o",
        "norm2", "router", "correction_bias", "w1", "w3", "w2", "shared_w1",
        "shared_w3", "shared_w2"]
    for li, block in enumerate(model.blocks):
        leaf = w.layer(li)
        m, moe = block.mla, block.moe
        pairs = [(m.w_dq, "q_a"), (m.q_norm, "q_a_norm"), (m.w_uq, "q_b"),
                 (m.w_dkv, "kv_a"), (m.kv_norm, "kv_a_norm"), (m.wo, "o"),
                 (moe.router, "router"),
                 (moe.correction_bias, "correction_bias"),
                 (moe.w_gate, "w1"), (moe.w_up, "w3"), (moe.w_down, "w2"),
                 (moe.shared.w_gate, "shared_w1"),
                 (moe.shared.w_up, "shared_w3"),
                 (moe.shared.w_down, "shared_w2"),
                 (block.norm1, "norm1"), (block.norm2, "norm2")]
        for param, name in pairs:
            assert param.dtype == leaf[name].dtype, name
            assert torch.equal(param, leaf[name]), (li, name)
        assert moe.router.dtype == moe.correction_bias.dtype == torch.float32
        h, kl = c["num_attention_heads"], c["kv_lora_rank"]
        kv_b = torch.cat([m.w_uk.permute(2, 0, 1), m.w_uv.permute(1, 0, 2)],
                         dim=-1).reshape(kl, -1)
        assert kv_b.shape == (kl, h * (c["qk_nope_head_dim"]
                                       + c["v_head_dim"]))
        assert torch.equal(kv_b, leaf["kv_b"])


def test_published_keys_at_the_top_level_are_the_config_group():
    """The file gives the published keys twice: at its top level, where
    they are held against the published config.json, and in `config`,
    which the harness reads. The two copies are the same numbers, and the
    top level holds every key of the published config but the two cells'
    own (`router_experts`, `first_held_expert`)."""
    sp = spec.load(CELL)
    c = sp.config["config"]
    published = set(c) - {"router_experts", "first_held_expert"}
    assert published <= set(sp.config)
    for key in published:
        assert sp.config[key] == c[key], key
    assert sp.config["first_k_dense_replace"] == 1
    assert sp.config["num_hidden_layers"] == sp.config["layers"] == 30
    assert sp.config["n_routed_experts"] == 12


@pytest.mark.parametrize("key,value", [("moe_intermediate_size", 48),
                                       ("n_routed_experts", 8),
                                       ("first_held_expert", 4),
                                       ("routed_scaling_factor", 2.5),
                                       ("scoring_func", "softmax")])
def test_check_port_refuses_another_configuration(key, value):
    sp = _stand_in()
    cfg = program.port_config(sp.config)
    mla_moe.check_port(cfg, sp.config["config"])
    with pytest.raises(SystemExit, match="has"):
        mla_moe.check_port(cfg, {**sp.config["config"], key: value})


def test_work_counts_at_the_published_widths():
    """By hand, per token and layer: MLA 11,010,048 (q_a) + 18,874,368
    (q_b) + 4,128,768 (kv_a) + 8,388,608 (kv_b) + 58,720,256 (o); the
    router 2,752,512; the shared expert 44,040,192; a quarter of an expert
    on average (8 choices x 12 held / 384) 11,010,048. Attention per head
    192 / 128 over 64 heads."""
    c = spec.load(CELL).config["config"]
    mla_part = 11_010_048 + 18_874_368 + 4_128_768 + 8_388_608 + 58_720_256
    assert mla_moe.matmul_weights(c) == \
        mla_part + 2_752_512 + 44_040_192 + 11_010_048
    assert mla_moe.attention_dims(c) == (64, 64, 192, 128)
    flops = workcount.prefill_flops("mla_moe", c, 30, 8, 4096)
    assert flops == pytest.approx(394.6e12, rel=1e-3)


def _forward(ids, *, layers: int, rows: int, scale: float = 1.0):
    """One made-up `forward` tree: per layer an attention span (2 ms) and
    a `moe` span of 10 ms (route 1, shared 1.5, dispatch 0.5 with `rows`
    rows over 12 held experts, experts 4, combine 1, 2 of its own); the
    head 3 ms; the root 1 ms more than its children; every time times
    `scale`."""
    root = next(ids)
    out, total = [], 0.0

    def add(name, parent, ms, **attrs):
        s = Span(name, attrs, next(ids), parent, root, ms * scale)
        out.append(s)
        return s
    for _ in range(layers):
        add("attention", root, 2.0, route="kernel")
        m = add("moe", root, 10.0)
        add("moe.route", m.id, 1.0)
        add("moe.shared", m.id, 1.5)
        add("moe.dispatch", m.id, 0.5, held=12, rows=rows,
            rows_max=rows // 8)
        add("moe.experts", m.id, 4.0)
        add("moe.combine", m.id, 1.0)
        total += 12.0
    add("head", root, 3.0)
    total += 4.0
    return [Span("forward", {"mode": "prefill"}, root, None, root,
                 total * scale)] + out


def _run(*, probe: bool = True, warm: int = 1, window: int = 2,
         after: int = 2, layers: int = 3):
    ids = itertools.count(1)
    found, roots = [], []
    for scale, n in ((7.0, warm), (1.0, window), (11.0, after)):
        for _ in range(n):
            tree = _forward(ids, layers=layers,
                            rows=8192 if scale == 1.0 else 100, scale=scale)
            found += tree
            if scale == 1.0:
                roots.append(tree[0].device_ms)
    sp = spec.load(CELL)
    calls = {"attention": [(2.0, [], {})] * (layers * window)} if probe \
        else {}
    r = harness.Readings(sp.config, {**sp.traffic, "warmup_batches": warm},
                         window, 1.0, roots, calls, {})
    return found, r


@pytest.fixture
def recorded(monkeypatch):
    def use(found):
        spans._read.clear()
        monkeypatch.setattr(spans, "_stop", lambda: found)
    yield use
    spans._read.clear()


def test_the_readers_read_the_window(recorded):
    found, r = _run()
    recorded(found)
    got = {name: spec.reader(name).read(r) for name in READERS}
    forward = 3 * 12.0 + 4.0
    assert got["moe_route_share.prefill"] == pytest.approx(
        100.0 * 3 * 1.0 / forward)
    assert got["moe_shared_share.prefill"] == pytest.approx(
        100.0 * 3 * 1.5 / forward)
    d, f = 7168, 2048
    least = workcount.least_seconds(8192 * 6 * d * f,
                                    2 * (12 * 3 * d * f + 2 * 8192 * d))
    assert least == pytest.approx(8192 * 6 * d * f / 989e12)
    assert got["moe_grouped_roofline.prefill"] == pytest.approx(
        100.0 * 2 * 3 * least / (2 * 3 * 4e-3))
    for name in READERS:
        assert spec.reader(name).PROBES == {
            "attention": "repro_torch.models.layers:flash_attention"}


def test_without_the_attention_probe_the_readers_read_none(recorded):
    """No reader of another cell installs the probe: without its calls
    the window's attention spans match nothing, and every reader reads
    None."""
    found, r = _run(probe=False)
    recorded(found)
    assert {name: spec.reader(name).read(r) for name in READERS} == \
        dict.fromkeys(READERS)


def test_a_cell_without_the_dropless_moe_reads_none(recorded):
    """phi's spans (a `moe.dispatch` with slots and kept tokens, no route
    share of its own here, no shared expert) give the grouped roofline
    and the shared share nothing to read."""
    from test_portbench_spans import _run as phi_run
    found, r = phi_run("phi3.5-moe-16l.prefill-2k")
    recorded(found)
    assert spec.reader("moe_grouped_roofline.prefill").read(r) is None
    assert spec.reader("moe_shared_share.prefill").read(r) is None


def no_shared(prefill):
    """The shared expert left out: its down projection zeroed in every
    layer before the first batch."""
    def broken(model, prompts):
        for block in model.blocks:
            block.moe.shared.w_down.zero_()
        return prefill(model, prompts)
    return broken


def _cell_run(fault=None) -> dict:
    return harness.run(_stand_in(), 20260031, 0.0, False, device=CPU,
                       t0=time.perf_counter(), batches=4, fault=fault)


def test_sound_run_is_correct():
    res = _cell_run()
    assert res["correct"], res["check"]
    assert res["check"]["replay_diff"]["value"] == 0
    assert set(res["routing"]) == {"held_pct", "rows_max", "rows_min",
                                   "load_max"}


@pytest.mark.parametrize("fault", [stale, half, altered, tail, no_shared])
def test_broken_run_is_not_correct(fault):
    res = _cell_run(fault)
    assert not res["correct"], res["check"]


def test_control_is_not_correct():
    sp = _stand_in()
    c, tr = sp.config["config"], sp.traffic
    stream = Prompts(8, "prompts", c["vocab_size"], tr["batch"],
                     tr["prompt_len"], CPU)
    prompts = torch.cat([stream.next()
                         for _ in range(sp.limits["check_batches"])])
    numbers = check.control(sp.config, Weights(sp.config, 8, CPU), prompts)
    correct, shown = check.judge(numbers, sp.limits)
    assert not correct, shown
