"""The port's coding ops against the reference's Pallas ops.

Inputs come from numpy seeds and go through `repro.kernels.ops` (Pallas in
interpret mode) and `repro_torch.kernels.ops` on CPU tensors (the kernels'
plain PyTorch versions). GF(2^8) coding is exact: every comparison is
byte equality, no tolerance. The CUDA kernels themselves are held against
their plain versions in tests/test_torch_cuda.py, which needs a card.
"""
import numpy as np
import pytest
import torch

from repro.core import paper_schemes as ref_paper_schemes
from repro.core.codec import decode_plan as ref_decode_plan
from repro.core.codec import single_recovery_plan as ref_single_plan
from repro.core.gf import expand_coding_matrix_to_bits as ref_expand_bits
from repro.core.gf import gf_matmul as ref_gf_matmul
from repro.kernels import ops as ref_ops
from repro_torch.core import (code_from_state, decode_plan, make_alrc,
                              make_unilrc, paper_schemes, single_recovery_plan)
from repro_torch.core.gf import (expand_coding_matrix_to_bits,
                                 gf_bit_columns, gf_matmul)
from repro_torch.kernels import gf_bitmatmul as gfk
from repro_torch.kernels import ops
from repro_torch.kernels import xor_reduce as xrk
from repro_torch.kernels.ref import (gf_bitmatmul_ref, gf_matmul_ref,
                                     xor_reduce_ref)

SCHEMES = ("30-of-42", "112-of-136", "180-of-210")
NAMES = ("ALRC", "OLRC", "ULRC", "UniLRC")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint8))


def _rng_bytes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture
def port_counters():
    ops.reset_kernel_launch_counts()
    yield ops.KERNEL_LAUNCHES
    ops.reset_kernel_launch_counts()


# -- host algebra: the port's copies build the reference's codes -------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_codes_match_reference(scheme):
    ref, port = ref_paper_schemes(scheme), paper_schemes(scheme)
    for name in NAMES:
        r, p = ref[name], port[name]
        assert (r.name, r.n, r.k, r.groups, r.block_type, r.meta) == \
            (p.name, p.n, p.k, p.groups, p.block_type, p.meta)
        assert np.array_equal(r.A, p.A) and np.array_equal(r.checks, p.checks)
        carried = code_from_state(r.name, r.n, r.k, r.A, r.groups, r.checks,
                                  r.block_type, r.meta)
        assert np.array_equal(carried.A, p.A) and carried.groups == p.groups


def test_bit_columns_are_the_bit_matrix():
    A = _rng_bytes(1, (5, 9))
    cols = gf_bit_columns(A)                             # (m, k, 8)
    bits = expand_coding_matrix_to_bits(A)               # (8m, 8k)
    unpacked = (cols[:, :, :, None] >> np.arange(8)) & 1  # [i, j, b, o]
    assert np.array_equal(unpacked.transpose(0, 3, 1, 2).reshape(40, 72), bits)
    assert np.array_equal(bits, ref_expand_bits(A))


# -- plain versions and oracles agree ------------------------------------------

@pytest.mark.parametrize("m,k,B", [(1, 1, 1), (1, 20, 37), (2, 5, 512),
                                   (12, 30, 3000), (21, 180, 200),
                                   (30, 180, 640)])
def test_gf_plain_matches_oracles(m, k, B):
    A = _rng_bytes(m * 1000 + k, (m, k))
    data = _rng_bytes(B, (k, B))
    want = gf_matmul(A, data)
    assert np.array_equal(want, ref_gf_matmul(A, data))
    got = gfk.gf_bitmatmul_plain(_t(gf_bit_columns(A)), _t(data)[None])[0]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(gf_matmul_ref(_t(A), _t(data)).numpy(), want)
    assert np.array_equal(
        gf_bitmatmul_ref(expand_coding_matrix_to_bits(A), _t(data)).numpy(),
        want)


def test_gf_plain_edge_values():
    k, B = 7, 100
    data = np.full((k, B), 0xFF, dtype=np.uint8)
    eye = _t(gf_bit_columns(np.eye(k, dtype=np.uint8)))
    assert np.array_equal(gfk.gf_bitmatmul(eye, _t(data)[None])[0].numpy(),
                          data)
    zeros = _t(gf_bit_columns(np.zeros((3, k), dtype=np.uint8)))
    assert not gfk.gf_bitmatmul(zeros, _t(data)[None]).any()


@pytest.mark.parametrize("s", [1, 2, 3, 7, 17, 21, 29])
def test_xor_plain_matches_oracle(s):
    blocks = _rng_bytes(s, (3, s, 1001))
    got = xrk.xor_reduce_plain(_t(blocks))
    for i in range(3):
        assert np.array_equal(got[i].numpy(),
                              xor_reduce_ref(_t(blocks[i])).numpy())


def test_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        xrk.xor_reduce(torch.zeros((1, 2, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        xrk.xor_reduce(torch.zeros((2, 16), dtype=torch.uint8))
    cols = torch.zeros((2, 3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        gfk.gf_bitmatmul(cols, torch.zeros((1, 4, 16), dtype=torch.uint8))
    with pytest.raises(TypeError):
        ops.xor_fold_many(np.zeros((1, 2, 16), dtype=np.uint8))


def test_cpu_tensors_take_the_plain_versions():
    gfk.reset_counts()
    xrk.reset_counts()
    data = _t(_rng_bytes(3, (4, 64)))
    ops.apply_matrix(_rng_bytes(4, (2, 4)), data)
    ops.xor_fold(data)
    assert (gfk.plain_calls, gfk.launches) == (1, 0)
    assert (xrk.plain_calls, xrk.launches) == (1, 0)


# -- the port's ops against the reference's ops, byte for byte -----------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", NAMES)
def test_encode_matches_reference(scheme, name, port_counters):
    code = paper_schemes(scheme)[name]
    ref_code = ref_paper_schemes(scheme)[name]
    B = 300 if scheme == "180-of-210" else 1000
    seed = 10 * SCHEMES.index(scheme) + NAMES.index(name)
    data = _rng_bytes(seed, (2, code.k, B))
    want = np.asarray(ref_ops.encode_many(ref_code, data))
    got = ops.encode_many(code, _t(data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.encode(code, _t(data[1])).numpy(), want[1])
    assert np.array_equal(want[0], ref_code.encode(data[0]))
    assert port_counters == {"gf_bitmatmul": 2}


@pytest.mark.parametrize("m,k,B", [(1, 1, 8), (1, 20, 3000), (3, 9, 3000),
                                   (21, 40, 129)])
def test_apply_matrix_matches_reference(m, k, B):
    M = _rng_bytes(m + k, (m, k))
    blocks = _rng_bytes(B, (2, k, B))
    want = np.asarray(ref_ops.apply_matrix_many(M, blocks))
    assert np.array_equal(ops.apply_matrix_many(M, _t(blocks)).numpy(), want)
    assert np.array_equal(ops.apply_matrix(M, _t(blocks[0])).numpy(),
                          np.asarray(ref_ops.apply_matrix(M, blocks[0])))


@pytest.mark.parametrize("s", [2, 3, 7, 17, 21])
@pytest.mark.parametrize("B", [4096, 3001])
def test_xor_fold_matches_reference(s, B):
    blocks = _rng_bytes(s * B, (3, s, B))
    want = np.asarray(ref_ops.xor_fold_many(blocks))
    assert np.array_equal(ops.xor_fold_many(_t(blocks)).numpy(), want)
    assert np.array_equal(ops.xor_fold(_t(blocks[2])).numpy(),
                          np.asarray(ref_ops.xor_fold(blocks[2])))


@pytest.mark.parametrize("make,targets", [
    (lambda: make_unilrc(1, 6), (0, 17, 30, 36, 41)),
    (lambda: make_alrc(30, 6, 6), (0, 31, 37)),      # 31: Cauchy global
])
def test_recover_matches_reference(make, targets, port_counters):
    code = make()
    data = _rng_bytes(7, (3, code.k, 555))
    cw = np.asarray(ref_ops.encode_many(code_ref(code), data))
    expect = {"xor_reduce": 0, "gf_bitmatmul": 0}
    for t in targets:
        plan = single_recovery_plan(code, t)
        ref_plan = ref_single_plan(code_ref(code), t)
        assert (plan.sources, plan.coeffs) == (ref_plan.sources,
                                               ref_plan.coeffs)
        stacked = {s: cw[:, s] for s in plan.sources}
        want = np.asarray(ref_ops.recover_many(ref_plan, stacked))
        assert np.array_equal(want, cw[:, t])
        got = ops.recover_many(plan, {s: _t(v) for s, v in stacked.items()})
        assert np.array_equal(got.numpy(), want)
        one = ops.recover_single(plan, {s: _t(cw[0, s]) for s in plan.sources})
        assert np.array_equal(one.numpy(), cw[0, t])
        expect["xor_reduce" if plan.xor_only else "gf_bitmatmul"] += 2
    assert port_counters == {k: v for k, v in expect.items() if v}


@pytest.mark.parametrize("erased", [(0, 5, 11, 25, 31, 35), (3,), (24, 25)])
def test_apply_decode_matches_reference(erased, port_counters):
    code = make_unilrc(2, 4)                             # (36, 24, 8)
    data = _rng_bytes(8, (2, code.k, 1536))
    cw = code_ref(code).encode(data[0]), code_ref(code).encode(data[1])
    cw = np.stack(cw)
    plan = decode_plan(code, erased)
    ref_plan = ref_decode_plan(code_ref(code), erased)
    assert plan.sources == ref_plan.sources
    assert np.array_equal(plan.M, ref_plan.M)
    stacked = {s: cw[:, s] for s in plan.sources}
    want = ref_ops.apply_decode_many(ref_plan, stacked)
    got = ops.apply_decode_many(plan, {s: _t(v) for s, v in stacked.items()})
    one = ops.apply_decode(plan, {s: _t(cw[1, s]) for s in plan.sources})
    for e in erased:
        assert np.array_equal(np.asarray(want[e]), cw[:, e])
        assert np.array_equal(got[e].numpy(), cw[:, e])
        assert np.array_equal(one[e].numpy(), cw[1, e])
    assert sum(port_counters.values()) == 2


def code_ref(code):
    """The reference's Code with the port code's contents."""
    from repro.core.codes import Code
    return Code(code.name, code.n, code.k, code.A.copy(), code.groups,
                code.checks.copy(), code.block_type, dict(code.meta))


# -- launch accounting and the planner -------------------------------------------

def test_launch_scopes_are_per_thread(port_counters):
    import threading

    from repro_torch.kernels.ops import (kernel_launch_snapshot,
                                         launch_scope, launches_since)
    snap = kernel_launch_snapshot()
    data = _t(_rng_bytes(1, (1, 3, 64)))
    seen = {}

    def worker(i):
        with launch_scope() as scope:
            for _ in range(i + 1):
                ops.xor_fold_many(data)
            seen[i] = scope.total

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert seen == {0: 1, 1: 2, 2: 3, 3: 4}
    assert launches_since(snap) == 10
    with launch_scope() as outer, launch_scope() as inner:
        ops.apply_matrix(np.ones((1, 3), np.uint8), data[0])
    assert outer.counts == inner.counts == {"gf_bitmatmul": 1}


def test_autotune_keeps_the_reference_planner_and_cache(tmp_path,
                                                        monkeypatch):
    from repro.kernels import autotune as ref_autotune
    from repro_torch.kernels import autotune
    for k, n, bs in ((30, 42, 1 << 20), (180, 210, 1 << 20), (4, 6, 7)):
        assert autotune.plan_stream_windows(k, n, bs) == \
            ref_autotune.plan_stream_windows(k, n, bs)
    plan = autotune.matmul_plan(180, 30, 1 << 20)
    assert (plan.pad, plan.smem_bytes, plan.grid_steps) == (0, 23040, 256)
    assert autotune.xor_plan(20, 3001).grid_steps == 1
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    with pytest.raises(ValueError):
        autotune.save_timings({"x": {}})
    path = tmp_path / "timings.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    key = autotune.matmul_key(180, 30, 1 << 20)
    autotune.save_timings({key: {"block_b": 4096, "seconds": 0.0087}})
    assert autotune.load_timings() == {key: {"block_b": 4096,
                                             "seconds": 0.0087}}
    assert ref_autotune.load_timings(path) == autotune.load_timings()
    path.write_text("{not json")
    assert autotune.load_timings() == {}
