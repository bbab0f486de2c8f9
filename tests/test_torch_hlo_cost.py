"""The port's static cost (`launch.hlo_cost`) on traced steps, the tests
of the reference's `tests/test_hlo_cost.py` ported: a Python loop is
traced once per iteration, so its FLOPs need no trip count; and the
FLOPs are per device, on the local shards."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import torch

from repro_torch.launch.hlo import TraceRecorder
from repro_torch.launch.hlo_cost import analyze
from repro_torch.launch.specs import fake_mode

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _traced(fn, *shapes):
    with fake_mode():
        args = [torch.empty(s) for s in shapes]
        rec = TraceRecorder(None)
        with rec:
            fn(*args)
    return analyze(rec.trace)


def test_loop_flops_count_every_iteration():
    """A 7-iteration loop of a (64 x 64) @ (64 x 64) matmul costs 7 times
    the single matmul (2 x 64^3 each)."""
    def fn(x, w):
        for _ in range(7):
            x = x @ w
        return x
    cost = _traced(fn, (64, 64), (64, 64))
    expect = 7 * 2 * 64 ** 3
    assert expect * 0.9 <= cost.flops <= expect * 1.6, cost.flops


def test_nested_loops_multiply():
    def fn(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    cost = _traced(fn, (32, 32), (32, 32))
    expect = 15 * 2 * 32 ** 3
    assert expect * 0.9 <= cost.flops <= expect * 1.8, cost.flops


def test_plain_dot_flops():
    cost = _traced(lambda a, b: a @ b, (128, 256), (256, 64))
    expect = 2 * 128 * 256 * 64
    assert expect * 0.99 <= cost.flops <= expect * 1.01, cost.flops
    # bytes: the operands and the result, fp32
    assert cost.bytes == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_sharded_matmul_counts_a_quarter_per_device():
    """(64, 128) @ (128, 256) with the weight's columns split over a model
    axis of 4: each device multiplies by its (128, 64) shard, a quarter of
    the global FLOPs, with no collective."""
    code = """
    import json, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo import TraceRecorder
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.launch.specs import fake_mode
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    with fake_mode():
        x = DTensor.from_local(torch.empty(64, 128), mesh,
                               [Replicate(), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(128, 64), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        rec = TraceRecorder(mesh)
        with rec:
            x @ w
    print(json.dumps(analyze(rec.trace).to_json()))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["flops"] == 2 * 64 * 128 * 256 / 4
    assert got["coll_count_by_op"] == {}
