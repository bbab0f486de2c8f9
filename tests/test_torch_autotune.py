"""The port's launch planner (`repro_torch.kernels.autotune`, ROADMAP A5):
with no timings file the planned launch is the kernels' own default, a
measured entry reaches the plan (clamped into the kernel's range, a
malformed one ignored), and `measure_matmul_tiles` round-trips through
`save_timings` on the CPU, where it times the plain version. The launches
themselves are held on the card in tests/test_torch_cuda.py.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.core import make_unilrc
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import gf_bitmatmul as gfk
from repro_torch.kernels import xor_reduce as xrk

MIB = 1 << 20
# chip_smoke.py phase 3's shapes: (k, m, S, B) of the encode, the cluster
# decode, the delta terms (one, two, five sources), two passes, K padded,
# ragged, the save batch
GF_SHAPES = [(180, 30, 8, MIB), (180, 21, 8, MIB), (1, 21, 1, MIB),
             (2, 42, 1, MIB), (5, 105, 1, MIB), (180, 30, 2, 4096),
             (20, 1, 3, 3000), (1, 1, 2, 1000), (180, 30, 2, 4097),
             (180, 30, 36, 256)]
# (s, S, B) of phase 3's XOR cases
XOR_SHAPES = [(20, 23, MIB), (2, 1, 3001), (29, 4, 4097)]


@pytest.fixture
def timings(tmp_path, monkeypatch):
    """A timings file named by the environment, plans recomputed before
    and after (the planners memoize)."""
    path = tmp_path / "timings.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.invalidate_plan_cache()
    yield path
    monkeypatch.delenv(autotune.CACHE_ENV)
    autotune.invalidate_plan_cache()


@pytest.fixture
def no_timings(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.invalidate_plan_cache()
    yield
    autotune.invalidate_plan_cache()


@pytest.mark.parametrize("k,m,S,B", GF_SHAPES)
def test_without_timings_the_gf_plan_is_the_models(no_timings, k, m, S, B):
    plan = autotune.plan_matmul_tiles(k, m, B, S=S)
    assert plan == autotune.matmul_plan(k, m, B, S=S)
    assert plan.source == "model"
    assert plan.grid_steps == min(S * -(-B // 128), autotune.H100_SMS)


@pytest.mark.parametrize("s,S,B", XOR_SHAPES)
def test_without_timings_the_xor_plan_is_the_models(no_timings, s, S, B):
    plan = autotune.plan_xor_tiles(s, B, S=S)
    assert plan == autotune.xor_plan(s, B) and plan.source == "model"
    assert plan.grid_steps == min(1024, -(-B // 4096))


def test_keys_are_the_reference_format_for_gf():
    assert autotune.matmul_key(180, 30, MIB) \
        == ref_autotune.matmul_key(180, 30, MIB) \
        == "gfmm:k=180:m=30:B=1048576"
    # the XOR kernel works on bytes, not int32 lanes
    assert autotune.xor_key(20, MIB) == "xor:s=20:bytes=1048576"


def test_candidates_are_sms_times_the_ctas_an_sm_holds():
    """sms x c for c up to the CTAs one SM holds at once (`resident`, the
    host code's occupancy count), capped at the tiles: one CTA an SM, as
    the H100 build holds, leaves the default alone."""
    assert autotune.matmul_candidates(1, 21, MIB) == [132]
    assert autotune.matmul_candidates(1, 21, MIB, resident=5) == [
        132, 264, 396, 528, 660]
    assert autotune.matmul_candidates(180, 30, MIB, S=8) == [132]
    # fewer tiles than SMs -> the tiles, whatever an SM holds
    assert autotune.matmul_candidates(180, 30, 256, S=2, resident=3) == [4]
    assert autotune.matmul_candidates(1, 21, MIB, sms=4, resident=5) == [
        4, 8, 12, 16, 20]
    assert autotune.matmul_candidates(1, 21, 5 * 128, sms=4,
                                      resident=3) == [4, 5]


def test_measure_save_and_plan_round_trip(timings):
    """`measure_matmul_tiles` on the CPU (the plain version, whatever the
    grid) at a tiny shape, merged by `save_timings`, which drops the
    memoized plans: the next plan is the measured one."""
    assert autotune.plan_matmul_tiles(1, 21, 4096).source == "model"
    entry = autotune.measure_matmul_tiles(1, 21, 4096, repeat=1,
                                          device="cpu", sms=8, resident=3)
    key = autotune.matmul_key(1, 21, 4096)
    assert list(entry) == [key]
    grids = autotune.matmul_candidates(1, 21, 4096, sms=8, resident=3)
    assert grids == [8, 16, 24]            # 32 tiles, 3 CTAs on 8 SMs
    assert entry[key]["grid_steps"] in grids
    assert sorted(map(int, entry[key]["candidates"])) == grids
    assert entry[key]["seconds"] > 0
    autotune.save_timings(entry)
    assert json.loads(timings.read_text())["entries"] == entry
    plan = autotune.plan_matmul_tiles(1, 21, 4096, sms=8, resident=3)
    assert (plan.source, plan.grid_steps) == (
        "measured", entry[key]["grid_steps"])
    # other fields are the model's
    assert plan == dataclasses.replace(
        autotune.matmul_plan(1, 21, 4096, sms=8), source="measured",
        grid_steps=entry[key]["grid_steps"])
    # on the CPU an SM holds one CTA unless told: the default alone
    assert autotune.measure_matmul_tiles(
        1, 21, 4096, repeat=1, device="cpu")[key]["candidates"].keys() \
        == {"32"}


@pytest.mark.parametrize("entry,want", [
    ({"grid_steps": 264}, ("measured", 264)),
    ({"grid_steps": 10_000}, ("measured", 660)),    # past 5 CTAs an SM
    ({"grid_steps": 0}, ("model", 132)),
    ({"grid_steps": -3}, ("model", 132)),
    ({"grid_steps": 2.5}, ("model", 132)),
    ({"grid_steps": True}, ("model", 132)),
    ({"grid_steps": "264"}, ("model", 132)),
    ({"block_b": 4096}, ("model", 132)),            # a reference entry
    ("264", ("model", 132)),
])
def test_gf_entries_are_clamped_or_ignored(timings, entry, want):
    """On SMs that each hold 5 CTAs at once: an entry past 5 x 132 is
    clamped there, one without a positive int is ignored."""
    autotune.save_timings({autotune.matmul_key(1, 21, MIB): entry})
    plan = autotune.plan_matmul_tiles(1, 21, MIB, resident=5)
    assert (plan.source, plan.grid_steps) == want


def test_a_gf_entry_is_clamped_to_the_tiles_and_the_smem(timings):
    """Clamped to the tiles, and to the SMs times the CTAs each holds at
    once (by shared memory, threads and registers: one, unless told)."""
    autotune.save_timings({
        autotune.matmul_key(180, 30, 256): {"grid_steps": 64},
        autotune.matmul_key(180, 30, MIB): {"grid_steps": 264}})
    assert autotune.plan_matmul_tiles(180, 30, 256, S=2,
                                      resident=5).grid_steps == 4
    assert autotune.plan_matmul_tiles(180, 30, MIB, S=8).grid_steps == 132
    assert autotune.plan_matmul_tiles(180, 30, MIB, S=8,
                                      resident=2).grid_steps == 264


@pytest.mark.parametrize("g,want", [(128, 128), (1, 1), (999, 256),
                                    (0, 256)])
def test_xor_entries_are_clamped_to_the_blocks(timings, g, want):
    autotune.save_timings({autotune.xor_key(20, MIB): {"grid_steps": g}})
    plan = autotune.plan_xor_tiles(20, MIB, S=23)
    assert plan.grid_steps == want
    assert plan.source == ("model" if g == 0 else "measured")


def test_a_broken_file_plans_the_model(timings):
    timings.write_text("{not json")
    assert autotune.plan_matmul_tiles(1, 21, MIB).source == "model"
    timings.write_text(json.dumps({"version": 99, "entries": {
        autotune.matmul_key(1, 21, MIB): {"grid_steps": 264}}}))
    autotune.invalidate_plan_cache()
    assert autotune.plan_matmul_tiles(1, 21, MIB).source == "model"


def test_ops_launch_by_the_plan_and_keep_the_bytes(timings, monkeypatch):
    """`ops` hands a measured plan's grid to the wrappers, and no grid
    where the plan is the model's; on CPU tensors the plain versions give
    the same bytes under any plan."""
    code = make_unilrc(1, 4)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 256, (3, code.k, 4096),
                                         dtype=np.uint8))
    blocks = torch.from_numpy(rng.integers(0, 256, (3, 5, 4096),
                                           dtype=np.uint8))
    seen = []
    real_gf, real_xor = gfk.gf_bitmatmul, xrk.xor_reduce

    def gf(cols, d, grid=None):
        seen.append(("gf", grid))
        return real_gf(cols, d, grid=grid)  # repro-lint: allow=RA001

    def xor(b, grid=None):
        seen.append(("xor", grid))
        return real_xor(b, grid=grid)  # repro-lint: allow=RA001
    monkeypatch.setattr(ops, "gf_bitmatmul", gf)
    monkeypatch.setattr(ops, "xor_reduce", xor)
    want = (ops.encode_many(code, data), ops.xor_fold_many(blocks))
    assert seen == [("gf", None), ("xor", None)]
    seen.clear()
    autotune.save_timings({
        autotune.matmul_key(code.k, code.n - code.k, 4096):
            {"grid_steps": 7},
        autotune.xor_key(5, 4096): {"grid_steps": 1}})
    got = (ops.encode_many(code, data), ops.xor_fold_many(blocks))
    assert seen == [("gf", 7), ("xor", 1)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_reject_a_bad_grid():
    cols = torch.zeros((2, 3, 8), dtype=torch.uint8)
    data = torch.zeros((1, 3, 16), dtype=torch.uint8)
    for bad in (0, -1, 2.0, True, "3"):
        with pytest.raises(ValueError):
            gfk.gf_bitmatmul(cols, data, grid=bad)  # repro-lint: allow=RA001
        with pytest.raises(ValueError):
            xrk.xor_reduce(data, grid=bad)  # repro-lint: allow=RA001
