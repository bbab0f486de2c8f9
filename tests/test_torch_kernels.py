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
from repro.kernels.ref import gf_bitmatmul_ref as ref_bitmatmul_ref
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
    # repro-lint: allow=RA001
    assert np.array_equal(gfk.gf_bitmatmul(eye, _t(data)[None])[0].numpy(),
                          data)
    zeros = _t(gf_bit_columns(np.zeros((3, k), dtype=np.uint8)))
    # repro-lint: allow=RA001
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
        # repro-lint: allow=RA001
        xrk.xor_reduce(torch.zeros((1, 2, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        # repro-lint: allow=RA001
        xrk.xor_reduce(torch.zeros((2, 16), dtype=torch.uint8))
    cols = torch.zeros((2, 3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        # repro-lint: allow=RA001
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


# -- the tensor-core kernel's arithmetic, emulated on the CPU ---------------------
#
# csrc/gf_matmul_sm90.cu computes the bit-plane product as int8 wgmma
# products: A from the data's nibble expansion in registers, B from the bit
# columns in shared memory, K in a permuted order, the 8k columns in passes
# whose parities are XORed, and the parity bits repacked over a quad of
# lanes. These tests run the same arithmetic in torch and hold it against
# the plain version and the reference's oracles.

def _nibble_bytes(x):
    """Four bits -> four bytes of 0 or 1 in a word, as the kernel does."""
    return (x * 0x00204081) & 0x01010101


def _word_bytes(w):
    """Words -> their four bytes, byte q = bits 8q .. 8q + 7."""
    return torch.stack([(w >> (8 * q)) & 0xFF for q in range(4)], dim=-1)


def _bit_column(N, i, o):
    """Column of bit o of output row i in an N tile, as the kernel lays
    them out: the first 4 (N // 32) rows so that lane t of a quad holds
    all bits of rows 4q + t, the rest one row per 8-column block."""
    if i < 4 * (N // 32):
        return 8 * (i & ~3) + 8 * (o >> 1) + 2 * (i & 3) + (o & 1)
    return 8 * i + o


def _kernel_operands(cols, data, N):
    """The wgmma operands of one N tile: A (S, B, 32 steps) from the data
    bytes and B (32 steps, N) from the tile's bit columns. Column
    32s + 16h + 4t + q of K is bit 4h + q of data row 4s + t (rows past k
    are zero)."""
    m, k, _ = cols.shape
    S, _, B = data.shape
    steps = -(-k // 4)
    x = torch.zeros((S, 4 * steps, B), dtype=torch.int64)
    x[:, :k] = data.long()
    planes = [_word_bytes(_nibble_bytes(x & 0xF)),
              _word_bytes(_nibble_bytes(x >> 4))]      # (S, 4 steps, B, q)
    a = torch.stack(planes, dim=2).reshape(S, steps, 4, 2, B, 4)
    a = a.permute(0, 4, 1, 3, 2, 5).reshape(S, B, 32 * steps)
    c = torch.zeros((m, 4 * steps, 8), dtype=torch.int64)
    c[:, :k] = cols.long()
    words = [sum(c[:, :, 4 * h + q] << (8 * q) for q in range(4))
             for h in range(2)]                          # (m, 4 steps)
    bits = torch.stack([torch.stack([_word_bytes((w >> o) & 0x01010101)
                                     for o in range(8)], dim=2)
                        for w in words], dim=2)          # (m, 4s, h, o, q)
    bits = bits.reshape(m, steps, 4, 2, 8, 4).permute(1, 3, 2, 5, 0, 4)
    bits = bits.reshape(32 * steps, m, 8)
    b = torch.zeros((32 * steps, N), dtype=torch.int64)
    for i in range(m):
        for o in range(8):
            b[:, _bit_column(N, i, o)] = bits[:, i, o]
    return a, b


def _quad_epilogue(parity):
    """Parity bits (S, B, 8g), B even, one output row per 8-column block
    -> bytes (S, g, B) through the kernel's quad transpose: lane t holds
    bits 2t, 2t+1 of every row for two byte positions, and two shuffles
    leave it whole bytes of the rows 4q + t."""
    S, B, N = parity.shape
    G = -(-N // 32) * 4                                  # rows, padded to 4
    d = torch.zeros((S, B // 2, 2, 8 * G), dtype=torch.int64)
    d[..., :N] = parity.reshape(S, B // 2, 2, N)
    d = d.reshape(S, B // 2, 2, G // 4, 4, 4, 2)         # [pos, q, u, t, e]
    t = torch.arange(4)                                 # lanes, last
    part = ((d[:, :, 0, ..., 0] | d[:, :, 0, ..., 1] << 1)
            | (d[:, :, 1, ..., 0] | d[:, :, 1, ..., 1] << 1) << 8) << (2 * t)
    part = part.transpose(-1, -2)                        # [.., q, t, u]
    w01 = part[..., 0] | part[..., 1] << 16
    w23 = part[..., 2] | part[..., 3] << 16
    hi2 = (torch.arange(4) & 2).bool()
    keep = torch.where(hi2, w23, w01)
    keep = keep | torch.where(hi2, w01, w23)[..., [2, 3, 0, 1]]
    hi1 = (torch.arange(4) & 1).bool()
    mine = torch.where(hi1, keep >> 16, keep & 0xFFFF)
    mine = mine | torch.where(hi1, keep & 0xFFFF, keep >> 16)[..., [1, 0, 3, 2]]
    out = torch.stack([mine & 0xFF, mine >> 8], dim=-1)  # [S, pos/2, q, t, 2]
    out = out.reshape(S, B // 2, G, 2).permute(0, 2, 1, 3).reshape(S, G, B)
    return out[:, :N // 8]


def _tile_epilogue(parity, N):
    """Parity bits (S, B, N) of one N tile, B even -> bytes (S, N // 8, B):
    lane t packs rows 4q + t, q < N // 32, from its own registers (block
    4q + b, columns 2t + e: bits 2b + e), the rest through the quad
    transpose."""
    S, B, _ = parity.shape
    F = N // 32
    d = parity[..., :32 * F].reshape(S, B // 2, 2, F, 4, 4, 2)  # [p, q, b, t, e]
    weight = 1 << (2 * torch.arange(4)[:, None] + torch.arange(2))  # [b, e]
    own = (d * weight[:, None, :]).sum(dim=(-3, -1))     # [S, p, pos, q, t]
    own = own.permute(0, 3, 4, 1, 2).reshape(S, 4 * F, B)
    return torch.cat([own, _quad_epilogue(parity[..., 32 * F:])], dim=1)


def _kernel_product(cols, data, step_ranges):
    """The kernel's arithmetic: per N tile of `gfk.kernel_plan`, int32
    products over each pass's steps, the passes' parities XORed, packed by
    the epilogue."""
    m, k, _ = cols.shape
    B = data.shape[2]
    plan = gfk.kernel_plan(m, k)
    N, R = plan["N"], plan["rows_per_tile"]
    if B % 2:
        data = torch.cat([data, torch.zeros_like(data[..., :1])], dim=2)
    rows = []
    for lo in range(0, m, R):
        a, b = _kernel_operands(cols[lo:lo + R], data, N)
        parity = 0
        for s0, s1 in step_ranges:
            acc = a[..., 32 * s0:32 * s1].int() @ b[32 * s0:32 * s1].int()
            assert int(acc.max()) <= 32 * (s1 - s0)       # exact in int32
            parity = parity ^ (acc.long() & 1)
        rows.append(_tile_epilogue(parity, N)[:, :min(R, m - lo)])
    return torch.cat(rows, dim=1)[..., :B].to(torch.uint8)


def _passes(k, per_pass):
    steps = -(-k // 4)
    return [(s, min(s + per_pass, steps)) for s in range(0, steps, per_pass)]


def test_nibble_expansion_is_the_bits():
    x = torch.arange(16)
    got = _word_bytes(_nibble_bytes(x))
    assert torch.equal(got, (x[:, None] >> torch.arange(4)) & 1)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_arithmetic_matches_reference(scheme, name):
    """Every paper code's encode matrix through the emulated kernel, with
    the kernel's own passes and with the steps split into two passes,
    against the plain version and the reference's oracles."""
    A = ref_paper_schemes(scheme)[name].A
    m, k = A.shape
    data = _rng_bytes(m + k, (2, k, 37))
    cols = _t(gf_bit_columns(A))
    want = gfk.gf_bitmatmul_plain(cols, _t(data))
    for s in range(2):
        assert np.array_equal(want[s].numpy(), ref_gf_matmul(A, data[s]))
        assert np.array_equal(
            want[s].numpy(), ref_bitmatmul_ref(ref_expand_bits(A), data[s]))
    steps = -(-k // 4)
    plan = gfk.kernel_plan(m, k)
    for ranges in (_passes(k, plan["steps_per_pass"]),
                   _passes(k, -(-steps // 2))):
        assert torch.equal(_kernel_product(cols, _t(data), ranges), want)


@pytest.mark.parametrize("m,k,B", [(21, 1, 64), (42, 2, 33), (105, 5, 16),
                                   (1, 20, 30), (1, 1, 1), (21, 180, 8),
                                   (16, 255, 6)])
def test_kernel_arithmetic_edge_shapes(m, k, B):
    A = _rng_bytes(7 * m + k, (m, k))
    data = _rng_bytes(B, (1, k, B))
    cols = _t(gf_bit_columns(A))
    want = gfk.gf_bitmatmul_plain(cols, _t(data))
    assert np.array_equal(want[0].numpy(), ref_gf_matmul(A, data[0]))
    plan = gfk.kernel_plan(m, k)
    got = _kernel_product(cols, _t(data), _passes(k, plan["steps_per_pass"]))
    assert torch.equal(got, want)


def test_reused_library_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A build writes ptxas's report beside the library; a process that
    finds the library built reads the report back (chip_smoke.py checks
    the spill counts in it on every run)."""
    from repro_torch.kernels import _build
    lib = tmp_path / "libreprocoding_test.so"
    report = "ptxas info    : Function properties for gf_matmul_sm90_kernel\n"

    def compile_(out):
        out.write_bytes(b"")
        out.with_suffix(".log").write_text(report)
        _build.build_log = report

    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_load", lambda path: path)
    monkeypatch.setattr(_build, "_LIB", None)
    assert _build.library() == str(lib)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "_compile", None)        # must not rebuild
    assert _build.library() == str(lib)
    assert _build.build_log == report and _build.build_seconds == 0.0


def test_kernel_plan_at_the_stripe_shapes():
    """The kernel's cuts at the main path's shapes: the encode width in two
    passes, the cluster decode padded to 176, the widest delta term in four
    N tiles; every plan fits a block's shared memory."""
    encode = gfk.kernel_plan(30, 180)
    assert (encode["N"], encode["k_passes"], encode["steps_per_pass"]) == \
        (240, 2, 23)
    assert gfk.kernel_plan(21, 180)["N"] == 176
    assert gfk.kernel_plan(105, 5)["n_tiles"] == 4
    assert gfk.kernel_plan(1, 1)["N"] == 32
    for m, k in ((30, 180), (21, 180), (105, 5), (1, 255), (30, 2000)):
        plan = gfk.kernel_plan(m, k)
        assert plan["smem"] <= gfk.SMEM_LIMIT
        assert 8 * plan["rows_per_tile"] <= plan["N"] <= 240
        assert plan["n_tiles"] * plan["rows_per_tile"] >= m
    assert gfk.pass_bytes(8, 30, 180, 1 << 20) == 2 * 8 * 30 * (1 << 20)


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
    # the encode's launch (gf_matmul_sm90.cu's host plan): 384 threads,
    # two K passes in 215,104 B of shared memory, one CTA per SM
    plan = autotune.matmul_plan(180, 30, 1 << 20)
    assert (plan.pad, plan.smem_bytes, plan.grid_steps) == (0, 215104, 132)
    assert (plan.threads, plan.passes, plan.n_width) == (384, 2, 240)
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


# (k, m, S, B) -> (threads, grid, smem, passes, N): the encode, the
# cluster decode and the delta terms, worked out by hand from
# `make_plan` in csrc/gf_matmul_sm90.cu (the card test compares the
# host's own plan)
GF_PLANS = [
    ((180, 30, 8, 1 << 20), (384, 132, 215104, 2, 240)),   # encode
    ((180, 21, 23, 1 << 20), (384, 132, 168000, 2, 176)),  # cluster decode
    ((1, 21, 1, 1 << 20), (384, 132, 10304, 1, 176)),      # delta terms
    ((2, 42, 1, 1 << 20), (384, 132, 10304, 1, 176)),      # over 2 N tiles
    ((180, 30, 1, 256), (384, 2, 215104, 2, 240)),         # 2 tiles: 2 CTAs
    ((20, 1, 2, 1000), (384, 16, 15424, 1, 32)),            # K padded
]


@pytest.mark.parametrize("shape,want", GF_PLANS)
def test_matmul_plan_is_the_gf_kernels_host_plan(shape, want):
    from repro_torch.kernels import autotune
    k, m, S, B = shape
    plan = autotune.matmul_plan(k, m, B, S=S)
    assert (plan.threads, plan.grid_steps, plan.smem_bytes, plan.passes,
            plan.n_width) == want
    assert plan.smem_bytes <= autotune.SMEM_LIMIT and plan.block_b == 128
    assert autotune.matmul_plan(k, m, B, S=S, sms=1).grid_steps == 1
