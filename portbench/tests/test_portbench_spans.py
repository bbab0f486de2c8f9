"""The readers of the port's spans (`portbench/spans.py` and the metrics
that read it) on made-up spans: each takes the window's roots by their
order, after the warm-up's and before the profiled stretch's, and reads
None where the spans do not match the run's other records (the attention
probe's calls, the prefill events) or where there are none; loading every
reader, as a test does, leaves the port's recorder off."""
from __future__ import annotations

import dataclasses
import itertools

import pytest
from portbench_cases import ROOT  # noqa: F401  (puts the port on the path)

from portbench import spans, spec, workcount
from portbench.harness import Readings

PHI = "phi3.5-moe-16l.prefill-2k"
MINICPM = "minicpm3-4b.prefill-2k"
READERS = ["moe_dispatch_share.prefill", "moe_experts_roofline.prefill",
           "moe_slot_use.prefill", "head_share.prefill"]


@dataclasses.dataclass(frozen=True)
class Span:
    """The fields of `repro_torch.obs.Span` that the readers read."""
    name: str
    attrs: dict
    id: int
    parent: int | None
    root: int
    device_ms: float | None


def _forward(ids, *, layers: int, attention_ms: float, moe: bool,
             kept: int, head_ms: float, slots: int = 640,
             scale: float = 1.0):
    """One made-up `forward` tree: per layer an attention span and, with
    `moe`, a `moe` span of 10 ms (route 1, dispatch 2, experts 5, combine
    1.5, 0.5 of its own); the head; the root 1 ms more than its children.
    Every time is multiplied by `scale`."""
    root = next(ids)
    out, total = [], 0.0

    def add(name, parent, ms, **attrs):
        s = Span(name, attrs, next(ids), parent, root, ms * scale)
        out.append(s)
        return s
    for _ in range(layers):
        add("attention", root, attention_ms, route="kernel")
        total += attention_ms
        if moe:
            m = add("moe", root, 10.0)
            add("moe.route", m.id, 1.0)
            add("moe.dispatch", m.id, 2.0, slots=slots, kept=kept)
            add("moe.experts", m.id, 5.0)
            add("moe.combine", m.id, 1.5)
            total += 10.0
    add("head", root, head_ms)
    total += head_ms + 1.0
    return [Span("forward", {"mode": "prefill"}, root, None, root,
                 total * scale)] + out


def _run(cell: str, *, warm=1, window=2, after=3, moe=True, layers=2):
    """(spans, readings) of a run: `warm` warm-up roots, `window` window
    roots, `after` roots of the stretch. Outside the window the head
    takes 20 ms, 100 tokens are kept, and every time is 7 or 11 times the
    window's, so that a reader reading them reads another number."""
    ids = itertools.count(1)
    found, roots = [], []
    for scale, n in ((7.0, warm), (1.0, window), (11.0, after)):
        for _ in range(n):
            inside = scale == 1.0
            tree = _forward(ids, layers=layers, attention_ms=2.0, moe=moe,
                            kept=600 if inside else 100,
                            head_ms=3.0 if inside else 20.0, scale=scale)
            found += tree
            if inside:
                roots.append(tree[0].device_ms)
    sp = spec.load(cell)
    calls = {"attention": [(2.0, [], {})] * (layers * window)}
    if moe:
        calls["moe"] = [(10.0, [], {})] * (layers * window)
    r = Readings(sp.config, {**sp.traffic, "warmup_batches": warm}, window,
                 1.0, roots, calls, {})
    return found, r


@pytest.fixture
def recorded(monkeypatch):
    """Hands `spans` the given spans as the recorder's, read afresh."""
    def use(found):
        spans._read.clear()
        monkeypatch.setattr(spans, "_stop", lambda: found)
    yield use
    spans._read.clear()


def _read_all(cell, r) -> dict:
    return {name: spec.reader(name).read(r) for name in READERS}


def test_the_readers_read_the_window(recorded):
    found, r = _run(PHI)
    recorded(found)
    got = _read_all(PHI, r)
    # a window root: 2 layers x (attention 2 + moe 10) + head 3 + own 1
    forward = 2 * (2 + 10) + 3 + 1
    assert got["moe_dispatch_share.prefill"] == pytest.approx(
        100.0 * 2 * (10 - 5) / forward)
    assert got["moe_slot_use.prefill"] == pytest.approx(100.0 * 600 / 640)
    assert got["head_share.prefill"] == pytest.approx(100.0 * 3 / forward)
    c = r.config["config"]
    d, f, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    least = workcount.least_seconds(600 * 6 * d * f,
                                    2 * (E * 3 * d * f + 2 * 600 * d))
    assert got["moe_experts_roofline.prefill"] == pytest.approx(
        100.0 * 2 * 2 * least / (2 * 2 * 5e-3))
    # one selection serves every reader
    assert len(spans._read) == 1 and len(spans._read[0]) == 2 * 14


def test_a_cell_without_moe_reads_only_the_head(recorded):
    found, r = _run(MINICPM, moe=False, warm=1, window=3, after=2)
    recorded(found)
    got = _read_all(MINICPM, r)
    assert got["head_share.prefill"] == pytest.approx(100.0 * 3 / (4 + 3 + 1))
    for name in READERS[:3]:
        assert got[name] is None


@pytest.mark.parametrize("fault", ["attention", "roots", "short", "none"])
def test_a_mismatch_reads_none(recorded, fault):
    found, r = _run(PHI)
    if fault == "attention":        # a probed call the spans lack
        r.calls["attention"].append((2.0, [], {}))
    elif fault == "roots":          # the prefill events 3% longer
        r.prefill_ms = [ms * 1.03 for ms in r.prefill_ms]
    elif fault == "short":          # fewer roots than the run's batches
        r.traffic = {**r.traffic, "warmup_batches": 5}
    else:                           # a port without the recorder
        found = None
    recorded(found)
    assert _read_all(PHI, r) == dict.fromkeys(READERS)


def test_a_mismatch_within_the_bound_reads(recorded):
    found, r = _run(PHI)
    r.prefill_ms = [ms * 1.015 for ms in r.prefill_ms]
    recorded(found)
    assert all(v is not None for v in _read_all(PHI, r).values())


@pytest.mark.parametrize("cell", [MINICPM, PHI])
def test_loading_the_readers_leaves_the_recorder_off(cell):
    obs = pytest.importorskip("repro_torch.obs")
    for m in spec.load(cell).per_layer:
        spec.reader(m["name"])
    spans.start()
    assert spans._recorder is None and obs._recorder is None
    assert obs.span("forward") is obs.span("head")
