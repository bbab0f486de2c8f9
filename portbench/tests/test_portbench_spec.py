"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name; a run without a card fails and prints no result."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
from portbench_cases import ROOT

from portbench import spec
from portbench.inputs import block_module

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert BENCH["command"][1] == "portbench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    sp = spec.load(cell)
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert (ROOT / cfg["file"]).is_file()
    assert sp.config["name"] == cfg["name"]
    assert sp.config["reduced"] == cfg["reduced"]
    for key in ("block_kind", "arch", "layers", "source", "config",
                "assumed", "departures", "deployment"):
        assert key in sp.config
    kind = sp.config["block_kind"]
    assert (spec.HERE / "blocks" / f"{kind}.py").is_file()
    block = block_module(kind)
    assert block.matmul_weights(sp.config["config"]) > 0
    assert len(block.attention_dims(sp.config["config"])) == 4
    assert (spec.HERE / "reference" / f"{kind}.py").is_file()
    assert sp.traffic["loop"] == "closed" and sp.traffic["gen"] == 1
    assert set(sp.limits["numbers"]) >= {"cache_err", "cache_err_max",
                                         "logit_err"}
    assert {m["name"] for m in sp.end_to_end} >= {"setup_s",
                                                  "prefill_tokens_s"}
    assert sp.per_layer
    for m in sp.per_layer:
        r = spec.reader(m["name"])
        assert callable(r.read) and isinstance(r.PROBES, dict)


def test_run_without_a_card_fails_without_result():
    """No card here: the run exits 2 and prints nothing on stdout; it does
    not fall back to the CPU."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert proc.stdout == ""
    assert "No result" in proc.stderr


def test_draw_scale_multiplies_the_named_leaves():
    """A configuration's `draw_scale` multiplies the named leaves' scale,
    in every layer, and leaves the rest of the bytes as they were."""
    import torch
    from portbench_cases import small_spec

    from portbench.inputs import Weights
    sp = small_spec("attn_moe")
    scale = {"embed": 64.0, "q": 2.0, "o": 0.5}
    base = Weights({**sp.config, "draw_scale": {}}, 7, torch.device("cpu"))
    got = Weights({**sp.config, "draw_scale": scale}, 7, torch.device("cpu"))
    assert torch.equal(got.top["embed"], base.top["embed"] * 64)
    assert torch.equal(got.top["unembed"], base.top["unembed"])
    for li in range(sp.config["layers"]):
        for name, leaf in base.layer(li).items():
            assert torch.equal(got.layer(li)[name],
                               leaf * scale.get(name, 1.0)), (li, name)


@pytest.mark.parametrize("cell,traffic,readers", [
    ("phi3.5-moe-16l.prefill-32k", (1, 32768), {
        "mfu.prefill", "attention_share.prefill",
        "attention_roofline.prefill", "moe_share.prefill",
        "device_idle.prefill", "moe_dispatch_share.prefill",
        "moe_experts_roofline.prefill", "moe_slot_use.prefill",
        "head_share.prefill"}),
    ("minicpm3-4b.prefill-256", (32, 256), {
        "mfu.prefill", "attention_share.prefill",
        "attention_roofline.prefill", "device_idle.prefill",
        "head_share.prefill"}),
])
def test_a_long_and_a_short_cell_find_their_pieces(cell, traffic, readers):
    """The cells of one prompt of 32,768 tokens and of 32 prompts of 256:
    their mix, their limits and their per-layer metrics are found by
    name."""
    sp = spec.load(cell)
    assert (sp.traffic["batch"], sp.traffic["prompt_len"]) == traffic
    assert sp.traffic["warmup_batches"] == 1 and sp.traffic["gen"] == 1
    assert sp.limits["check_batches"] >= 1
    assert {m["name"] for m in sp.per_layer} == readers
    for m in sp.per_layer:
        assert hasattr(spec.reader(m["name"]), "read")
