"""The long and the short cell's own limits (and batches checked) catch
what the 2k cells' do: a small stand-in of each (its block kind at SMOKE
widths, the harness as it runs) comes out correct unbroken, and not
correct with the timed path broken underneath or with the control, the
reference in fp8, in the program's place."""
from __future__ import annotations

import time

import pytest
import torch
from portbench_cases import small_spec
from test_portbench_faults import altered, half, stale, tail

from portbench import check, harness, spec
from portbench.inputs import Prompts, Weights

CPU = torch.device("cpu")
CELLS = {"phi3.5-moe-16l.prefill-32k": "attn_moe",
         "minicpm3-4b.prefill-256": "mla"}


def _stand_in(cell: str) -> spec.Spec:
    sp = small_spec(CELLS[cell])
    sp.cell, sp.limits = cell, spec.load(cell).limits
    return sp


def _run(cell: str, fault=None) -> dict:
    return harness.run(_stand_in(cell), 20260002, 0.0, False, device=CPU,
                       t0=time.perf_counter(), batches=4, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", [stale, half, altered, tail])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    sp = _stand_in(cell)
    c, tr = sp.config["config"], sp.traffic
    stream = Prompts(6, "prompts", c["vocab_size"], tr["batch"],
                     tr["prompt_len"], CPU)
    prompts = torch.cat([stream.next()
                         for _ in range(sp.limits["check_batches"])])
    numbers = check.control(sp.config, Weights(sp.config, 6, CPU), prompts)
    correct, shown = check.judge(numbers, sp.limits)
    assert not correct, shown
