"""The port's launch layer against the reference's: the cell list, the
collective tally and op audit of a traced step (`launch.hlo`), and the
abstract args of every runnable cell on both production meshes
(`launch.specs`). The production and fake meshes need a fake process
group of their own, so those tests run in a fresh interpreter, killed
after its timeout."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.launch import shapes as ref_shapes
from repro_torch.launch.hlo import OpRecord, Trace, count_ops
from repro_torch.launch.shapes import (SHAPES, all_cells, cell_status,
                                       runnable_cells)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _python(code: str, timeout: float) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cells_are_the_references():
    cells = all_cells()
    assert cells == ref_shapes.all_cells()
    assert len(cells) == 40
    assert len(runnable_cells()) == 31
    skipped = [(a, s, st) for a, s, st in cells if st != "run"]
    assert len(skipped) == 9
    assert all("skip" in st for _, _, st in skipped)
    assert cell_status("rwkv6-7b", "long_500k") == "run"
    assert "skip" in cell_status("hubert-xlarge", "decode_32k")
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in ref_shapes.SHAPES.items()}


_FAKE = """
import json, logging, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo import TraceRecorder, collective_stats
from repro_torch.launch.specs import fake_mode
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
"""


def test_row_parallel_matmul_is_one_all_reduce_over_model():
    """x (8, 16) split (batch over data, columns over model) times W (16,
    32) split by rows over model: the partial products are summed by one
    all-reduce over model of the output's local (4, 32) fp32 bytes."""
    got = _python(_FAKE + """
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
with fake_mode():
    x = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0), Shard(1)],
                           run_check=False)
    w = DTensor.from_local(torch.empty(8, 32), mesh,
                           [Replicate(), Shard(0)], run_check=False)
    rec = TraceRecorder(mesh, pod_size=4)
    with rec:
        y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
cs = collective_stats(rec.trace)
print(json.dumps({**cs.to_json(), "placements": str(y.placements),
                  "groups": [r.group for r in rec.trace.ops if r.kind]}))
""", 120)
    assert got["count_by_op"] == {"all-reduce": 1}
    assert got["bytes_by_op"] == {"all-reduce": 4 * 32 * 4}
    assert got["group_size_by_op"] == {"all-reduce": 2}
    assert got["groups"] == [["model"]]
    assert got["cross_pod_bytes"] == 0


def test_batch_all_reduce_over_pod_and_data_crosses_pods():
    """A partial sum over ("pod", "data") on a (2, 2, 2) mesh reduced to a
    replicated tensor: an all-reduce over pod, which spans the pods of 4
    devices and so counts as cross-pod, and one over data, which does
    not."""
    got = _python(_FAKE + """
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
with fake_mode():
    g = DTensor.from_local(torch.empty(16, 8), mesh,
                           [Partial(), Partial(), Replicate()],
                           run_check=False)
    rec = TraceRecorder(mesh, pod_size=4)
    with rec:
        g.redistribute(mesh, [Replicate()] * 3)
cs = collective_stats(rec.trace)
print(json.dumps({**cs.to_json(),
                  "groups": sorted(r.group for r in rec.trace.ops
                                   if r.kind)}))
""", 120)
    assert got["count_by_op"] == {"all-reduce": 2}
    assert got["bytes_by_op"] == {"all-reduce": 2 * 16 * 8 * 4}
    assert got["groups"] == [["data"], ["pod"]]
    assert got["cross_pod_bytes"] == 16 * 8 * 4
    assert got["total_bytes"] == 2 * 16 * 8 * 4


def test_shard_to_shard_is_one_all_to_all_of_the_local_bytes():
    """A (16, 8) fp32 tensor split by rows over model moved to a split by
    columns: one all-to-all over model, of the (8, 8) local input's bytes
    (recorded as the all-to-all NCCL runs, where a CPU mesh gathers and
    chunks). Pins the DTensor internal that `TraceRecorder` wraps."""
    got = _python(_FAKE + """
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
with fake_mode():
    x = DTensor.from_local(torch.empty(8, 8), mesh, [Replicate(), Shard(0)],
                           run_check=False)
    rec = TraceRecorder(mesh, pod_size=4)
    with rec:
        y = x.redistribute(mesh, [Replicate(), Shard(1)])
cs = collective_stats(rec.trace)
print(json.dumps({**cs.to_json(), "local": list(y.to_local().shape),
                  "groups": [r.group for r in rec.trace.ops if r.kind]}))
""", 120)
    assert got["count_by_op"] == {"all-to-all": 1}
    assert got["bytes_by_op"] == {"all-to-all": 8 * 8 * 4}
    assert got["group_size_by_op"] == {"all-to-all": 2}
    assert got["groups"] == [["model"]]
    assert got["local"] == [16, 4]


@pytest.mark.parametrize("owner, attr", [
    ("placement_types", "shard_dim_alltoall"),
    ("_sharding_prop.ShardingPropagator",
     "_propagate_tensor_meta_non_cached")])
def test_trace_recorder_refuses_a_torch_without_its_hooks(monkeypatch,
                                                         owner, attr):
    """`TraceRecorder` wraps two DTensor internals; where a torch lacks
    one it raises on entry, naming it, rather than miscount."""
    import functools

    import torch.distributed.tensor as dtensor

    from repro_torch.launch.hlo import TraceRecorder
    obj = functools.reduce(getattr, owner.split("."), dtensor)
    monkeypatch.delattr(obj, attr)
    with pytest.raises(RuntimeError, match=attr):
        with TraceRecorder(None):
            pass


def test_op_audit_counts_a_known_trace():
    ops = [OpRecord("aten.view.default", 0, 0),
           OpRecord("aten._unsafe_view.default", 0, 0),
           OpRecord("aten.transpose.int", 0, 0),
           OpRecord("aten.permute.default", 0, 0),
           OpRecord("aten.clone.default", 0, 8),
           OpRecord("aten.mm.default", 10, 8),
           OpRecord("repro_torch.flash_attention_fwd.default", 5, 8),
           OpRecord("repro_torch.flash_attention_fwd.default", 5, 8)]
    got = count_ops(Trace(ops, {}), ("reshape", "transpose", "copy",
                                     "custom", "mm"))
    assert got == {"reshape": 2, "transpose": 2, "copy": 1, "custom": 2,
                   "mm": 1}


_CELL_ARGS = """
import json, logging, sys
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, runnable_cells
from repro_torch.launch.specs import cell_args
from repro_torch.models.model import Transformer
from repro_torch.train.step import TrainState
mesh = make_production_mesh(multi_pod=sys.argv[1] == "multi", device="cpu")
out = {}
for arch, shape in runnable_cells():
    kind, args, shards, donate = cell_args(get_config(arch), SHAPES[shape],
                                           mesh)
    pairs = []
    for a, s in zip(args, shards):
        if isinstance(a, TrainState):
            pairs += list(zip(a.params, s["params"]))
            for n in ("master", "m", "v"):
                pairs += list(zip(a.opt[n], s["opt"][n]))
        elif isinstance(a, Transformer):
            pairs += list(zip(a.parameters(), s))
        elif isinstance(a, tuple):          # the cache
            for seg, ssh in zip(a, s):
                for blk, bsh in zip(seg, ssh):
                    pairs += [(blk[k], bsh[k]) for k in blk]
        elif s is not None:
            pairs.append((a, s))
    ok = all(isinstance(t, DTensor) and t.device_mesh is mesh
             and tuple(t.placements) == sh.placements for t, sh in pairs)
    out[f"{arch}/{shape}"] = [kind, len(pairs), ok]
print(json.dumps(out))
"""


def test_specs_build_for_every_runnable_cell():
    """`cell_args` places fake args for every runnable cell on both
    production meshes (one child process each, side by side): a
    shardings tree that covers the args, each tensor a DTensor on the mesh
    whose placements are its sharding's (as the reference's test_launch
    checks its trees cover each other)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {kind: subprocess.Popen(
        [sys.executable, "-c", _CELL_ARGS, kind], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for kind in ("single", "multi")}
    results = {}
    try:
        for kind, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-4000:]
            results[kind] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for kind, got in results.items():
        assert len(got) == 31, kind
        for cell, (cell_kind, n, ok) in got.items():
            assert cell_kind in ("train", "prefill", "encode", "decode"), cell
            assert n > 0 and ok, (kind, cell)


def test_top_contributors_rank_collectives_by_module():
    """`hlo_debug.top_contributors` sums a kind's result bytes by (module,
    group, size), largest first; loops need no trip count (one record a
    call)."""
    from repro_torch.launch.hlo_debug import top_contributors
    ops = ([OpRecord("_c10d_functional.all_gather_into_tensor.default", 0,
                     0, "all-gather", 100, ("data",), 16, False, "m.a")] * 3
           + [OpRecord("_c10d_functional.all_gather_into_tensor.default", 0,
                       0, "all-gather", 250, ("data",), 16, False, "m.b")]
           + [OpRecord("_c10d_functional.all_reduce.default", 0, 0,
                       "all-reduce", 999, ("model",), 16, False, "m.c")])
    rows = top_contributors(Trace(ops, {}), "all-gather", 5)
    assert [(r[0], r[1], r[3]) for r in rows] == [(300, 3, "m.a"),
                                                  (250, 1, "m.b")]
