"""The check fails what it must: a run of a small stand-in of each cell
(its block kind at SMOKE widths, the harness as it runs, the real cell's
limits) with the timed path broken underneath comes out not correct, and
so does the control, the reference in fp8 put in the program's place. The
same run unbroken comes out correct."""
from __future__ import annotations

import time

import pytest
import torch
from portbench_cases import small_spec

from portbench import check, harness
from portbench.inputs import Prompts, Weights

CPU = torch.device("cpu")


def stale(prefill):
    """A step that returns its state unchanged: every batch gets the
    first batch's logits and cache."""
    first = []

    def broken(model, prompts):
        if not first:
            first.append(prefill(model, prompts))
        return first[0]
    return broken


def half(prefill):
    """Half of the batch left out: the second half's outputs are the mean
    of the first half's."""
    def broken(model, prompts):
        h = prompts.shape[0] // 2
        logits, cache = prefill(model, prompts[:h])

        def fill(t, axis):
            mean = t.float().mean(dim=axis, keepdim=True).to(t.dtype)
            shape = list(t.shape)
            shape[axis] = prompts.shape[0] - h
            return torch.cat([t, mean.expand(shape)], dim=axis)
        cache = tuple(tuple({k: fill(v, 1) for k, v in blk.items()}
                            for blk in seg) for seg in cache)
        return fill(logits, 0), cache
    return broken


def altered(prefill):
    """An answer altered where it is produced: the first prompt's logits
    shifted by one token."""
    def broken(model, prompts):
        logits, cache = prefill(model, prompts)
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits, cache
    return broken


def tail(prefill):
    """A cache write wrong past some tile: every cache leaf's last quarter
    of positions left at zero. The logits are untouched (the prefill
    attends over fresh keys and values), and so is each row's median."""
    def broken(model, prompts):
        logits, cache = prefill(model, prompts)
        s = prompts.shape[1]

        def cut(t):
            t = t.clone()
            axis = list(t.shape).index(s, 2)        # after layers, batch
            t.narrow(axis, s - s // 4, s // 4).zero_()
            return t
        cache = tuple(tuple({k: cut(v) for k, v in blk.items()}
                            for blk in seg) for seg in cache)
        return logits, cache
    return broken


def _run(kind: str, fault=None) -> dict:
    return harness.run(small_spec(kind), 20260001, 0.0, False, device=CPU,
                       t0=time.perf_counter(), batches=4, fault=fault)


@pytest.mark.parametrize("kind", ["mla", "attn_moe"])
def test_sound_run_is_correct(kind):
    res = _run(kind)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", [stale, half, altered, tail])
@pytest.mark.parametrize("kind", ["mla", "attn_moe"])
def test_broken_run_is_not_correct(kind, fault):
    res = _run(kind, fault)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("kind", ["mla", "attn_moe"])
def test_control_is_not_correct(kind):
    sp = small_spec(kind)
    c, tr = sp.config["config"], sp.traffic
    stream = Prompts(5, "prompts", c["vocab_size"], tr["batch"],
                     tr["prompt_len"], CPU)
    prompts = torch.cat([stream.next() for _ in range(2)])
    numbers = check.control(sp.config, Weights(sp.config, 5, CPU), prompts)
    correct, shown = check.judge(numbers, sp.limits)
    assert not correct, shown
