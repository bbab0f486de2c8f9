"""The port's serving layer against the reference's, on the CPU: priority
and admission, the hot-block cache, the single and sharded front-ends,
the open-loop workload loop under virtual time, and the hazard
analyser behind `flush(analyze=True)`.

Both packages get the same code, topology, payload (numpy, from a seed),
failures and request script. Bytes, counts, shed decisions and hazard
verdicts must be equal; virtual-time latencies are equal too, because
both service models see the same launches and bytes (stated tolerance
rtol = 1e-12). The reference runs its kernels in Pallas interpret mode
where launch counts are compared, the port `TorchBackend("cpu")` (the
kernels' plain versions, counted like launches).
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.analysis import hazards as ref_hz
from repro.ckpt import BlockStore as RefStore
from repro.ckpt.stripe import StripeCodec as RefCodec
from repro.core.codes import make_unilrc as ref_make_unilrc
from repro.io import HotBlockCache as RefCache
from repro.io import RequestFrontend as RefFrontend
from repro.io import ServiceModel as RefServiceModel
from repro.io import ShardedFrontend as RefSharded
from repro.io import VirtualClock as RefClock
from repro.io import ZipfWorkload as RefZipf
from repro.io import drive_open_loop as ref_drive
from repro import priority as ref_pr
from repro.topo import Topology as RefTopology
from repro_torch import priority as pr
from repro_torch.analysis import hazards as hz
from repro_torch.ckpt import BlockStore, StripeCodec
from repro_torch.core.codes import make_unilrc
from repro_torch.io import (HotBlockCache, NumpyBackend, Priority,
                            RequestFrontend, RequestShed, ServiceModel,
                            ShardedFrontend, TorchBackend, VirtualClock,
                            ZipfWorkload, drive_open_loop)
from repro_torch.kernels import ops
from repro_torch.topo import Topology

CODE, REF_CODE = make_unilrc(1, 3), ref_make_unilrc(1, 3)   # n=12, k=6
BS = 64
TOPO = (3, 5)                     # one spare node per cluster
RTOL = 1e-12


def _payload(seed: int, stripes: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=CODE.k * BS * stripes, dtype=np.uint8).tobytes()


def _port(stripes=3, seed=0, backend=None):
    store = BlockStore(Topology(*TOPO))
    codec = StripeCodec(CODE, store, block_size=BS,
                        backend=backend or TorchBackend("cpu"))
    return store, codec, codec.write(_payload(seed, stripes))


def _ref(stripes=3, seed=0, backend="numpy"):
    store = RefStore(RefTopology(*TOPO))
    codec = RefCodec(REF_CODE, store, block_size=BS, backend=backend)
    return store, codec, codec.write(_payload(seed, stripes))


def _data_block(group: int = 0) -> int:
    return next(b for b in CODE.groups[group] if CODE.block_type[b] == 'd')


def _stats(stats) -> dict:
    return {int(p): dataclasses.asdict(c) for p, c in stats.items()}


def _value(v):
    """A request result as plain data (each package has its own report
    and stats classes)."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_value(x) for x in v)
    return v


def _outcome(h):
    if h.shed:
        return ("shed",)
    try:
        return ("ok", _value(h.result()))
    except Exception as exc:                 # a failed request
        return ("failed", type(exc).__name__)


# ---------------------------------------------------------------------------
# Priority, token buckets, admission
# ---------------------------------------------------------------------------

def test_priority_scale_and_risk_tiers_match():
    assert [(p.name, int(p)) for p in pr.Priority] == \
        [(p.name, int(p)) for p in ref_pr.Priority]
    assert pr.Priority.URGENT is pr.Priority.CLIENT_READ
    for p in pr.Priority:
        assert pr.tier_label(p) == ref_pr.tier_label(ref_pr.Priority(int(p)))
    for live in range(6):
        for f in range(5):
            assert int(pr.risk_tier(live, f)) == int(ref_pr.risk_tier(live, f))
            assert pr.failures_to_exposure(live, f) == \
                ref_pr.failures_to_exposure(live, f)


def test_token_bucket_matches_reference_in_virtual_time():
    clock, rclock = VirtualClock(), RefClock()
    bucket = pr.TokenBucket(rate=10.0, burst=5.0, clock=clock)
    rbucket = ref_pr.TokenBucket(rate=10.0, burst=5.0, clock=rclock)
    rng = np.random.default_rng(3)
    for _ in range(200):
        dt, n = float(rng.exponential(0.07)), float(rng.integers(1, 4))
        clock.advance(dt)
        rclock.advance(dt)
        assert bucket.try_take(n) == rbucket.try_take(n)
        assert bucket.tokens == rbucket.tokens
    with pytest.raises(ValueError):
        pr.TokenBucket(rate=0, burst=1)


def test_watermark_shed_order_matches_reference():
    cfg = dict(background_watermark=4, degraded_watermark=8)
    adm = pr.AdmissionController(pr.QoSConfig(**cfg))
    radm = ref_pr.AdmissionController(ref_pr.QoSConfig(**cfg))
    for p in pr.Priority:
        for pending in (0, 3, 4, 5, 8, 9, 10 ** 6):
            assert adm.admit(p, 1, pending=pending) == \
                radm.admit(ref_pr.Priority(int(p)), 1, pending=pending)
    # BACKGROUND sheds first, DEGRADED_READ second, CLIENT_READ never
    assert adm.admit(Priority.BACKGROUND, 1, pending=5) is not None
    assert adm.admit(Priority.DEGRADED_READ, 1, pending=5) is None
    assert adm.admit(Priority.CLIENT_READ, 1, pending=10 ** 6) is None
    with pytest.raises(ValueError):
        pr.QoSConfig(background_watermark=100, degraded_watermark=10)


def test_tenant_throttle_matches_reference():
    def run(pkg):
        port = pkg == "port"
        mod, Clock = (pr, VirtualClock) if port else (ref_pr, RefClock)
        store, codec, metas = _port() if port else _ref()
        clock = Clock()
        adm = mod.AdmissionController(
            mod.QoSConfig(background_watermark=10 ** 6,
                          degraded_watermark=10 ** 6, tenant_rate=1.0,
                          tenant_burst=float(2 * CODE.k)), clock=clock)
        fe = (RequestFrontend if port else RefFrontend)(
            codec, clock=clock, admission=adm)
        handles = [fe.submit_client_read(metas[i % 3], tenant="free")
                   for i in range(5)]
        clock.advance(float(CODE.k))         # one more read's worth
        handles += [fe.submit_client_read(metas[0], tenant="free"),
                    fe.submit_client_read(metas[1], tenant="free"),
                    fe.submit_client_read(metas[2])]   # unmetered
        fe.drain()
        return [_outcome(h) for h in handles], _stats(fe.stats)

    got, want = run("port"), run("ref")
    assert got == want
    outcomes, stats = got
    assert [o[0] for o in outcomes] == ["ok", "ok", "shed", "shed", "shed",
                                        "ok", "shed", "ok"]
    cli = stats[int(Priority.CLIENT_READ)]
    assert cli["requests"] + cli["shed_requests"] == 8


def test_shed_handle_reraises():
    store, codec, metas = _port()
    adm = pr.AdmissionController(pr.QoSConfig(background_watermark=0))
    fe = RequestFrontend(codec, admission=adm)
    h = fe.submit_scrub(metas)
    assert h.shed and h.done
    with pytest.raises(RequestShed, match="background-watermark"):
        h.result()
    assert fe.stats[Priority.BACKGROUND].shed_requests == 1


# ---------------------------------------------------------------------------
# Hot-block cache
# ---------------------------------------------------------------------------

def test_cache_lru_matches_reference():
    cache, rcache = HotBlockCache(capacity_blocks=3), RefCache(3)
    rng = np.random.default_rng(1)
    for _ in range(300):
        op, s, b = rng.integers(0, 4), int(rng.integers(0, 3)), \
            int(rng.integers(0, 4))
        if op == 0:
            data = bytes([s, b]) * 4
            cache.put(s, b, data)
            rcache.put(s, b, data)
        elif op == 1:
            assert cache.get(s, b) == rcache.get(s, b)
        elif op == 2:
            cache.invalidate(s, b)
            rcache.invalidate(s, b)
        else:
            pairs = [(s, b), (s, (b + 1) % 4)]
            cache.invalidate_many(pairs)
            rcache.invalidate_many(pairs)
        assert len(cache) == len(rcache)
        assert cache.contains(s, b) == rcache.contains(s, b)
    assert dataclasses.asdict(cache.stats) == dataclasses.asdict(rcache.stats)
    assert cache.stats.hit_rate == rcache.stats.hit_rate
    with pytest.raises(ValueError):
        HotBlockCache(capacity_blocks=0)


def _mutate(kind, store, codec, metas, node, b):
    """One store mutation path of block (0, b), whose node is down."""
    if kind == "rebuild":
        codec.rebuild_blocks([(0, b)], exclude_node=node)
        return
    if kind == "write":
        codec.write(bytes(range(64)) * (CODE.k * BS // 64), start_stripe=0)
        return
    store.heal_node(node)
    if kind == "put":
        store.put(0, b, node, bytes(BS))
    elif kind == "put_many":
        store.put_many([(0, b, node, b"\x01" * BS)])
    elif kind == "drop_block":
        store.drop_block(0, b)
    elif kind == "delete_node_blocks":
        store.delete_node_blocks(node)
    elif kind == "update_block":
        codec.update_block(metas[0], b, b"\x02" * BS)
        store.fail_node(node)


@pytest.mark.parametrize("kind", ["put", "put_many", "drop_block",
                                  "delete_node_blocks", "update_block",
                                  "rebuild", "write"])
def test_cache_invalidated_by_every_store_mutation_path(kind):
    """After any mutation of a cached block, a cached and an uncached
    front-end (and the reference's, on the same script) read the same
    bytes: the store's listeners invalidate, whatever the path."""
    b = _data_block()

    def run(pkg, cached):
        port = pkg == "port"
        store, codec, metas = _port() if port else _ref()
        node = store.node_of(0, b)
        store.fail_node(node)
        cache = (HotBlockCache if port else RefCache)(4) if cached else None
        fe = (RequestFrontend if port else RefFrontend)(codec, cache=cache)
        first = fe.submit_degraded_read(metas[0], b)
        fe.drain()
        invalidations = cache.stats.invalidations if cache else 0
        _mutate(kind, store, codec, metas, node, b)
        if cache is not None:
            assert not cache.contains(0, b)
        if store.available(0, b):
            h = fe.submit_client_read(metas[0])
        else:
            h = fe.submit_degraded_read(metas[0], b)
        fe.drain()
        grew = (cache.stats.invalidations if cache else 1) > invalidations
        return first.result(), h.result(), grew

    port_cached = run("port", True)
    assert port_cached == run("port", False) == run("ref", False)
    assert port_cached[2]


def test_cache_hit_skips_the_coding_path():
    store, codec, metas = _port()
    b = _data_block()
    store.drop_block(0, b)
    fe = RequestFrontend(codec, cache=HotBlockCache(8))
    first = fe.submit_degraded_read(metas[0], b)
    fe.drain()
    launches = fe.stats[Priority.DEGRADED_READ].launches
    again = fe.submit_degraded_read(metas[0], b)
    assert again.done and fe.pending == 0            # served at submit
    assert again.result() == first.result()
    cls = fe.stats[Priority.DEGRADED_READ]
    assert (cls.cache_hits, cls.launches) == (1, launches) and launches == 1


# ---------------------------------------------------------------------------
# Front-ends: the port against the reference on the same store state
# ---------------------------------------------------------------------------

def _serve_script(fe, metas, lost, parity, tenant_of):
    hs = [fe.submit_client_read(m, tenant=tenant_of(i))
          for i, m in enumerate(metas)]
    hs += [fe.submit_degraded_read(metas[s], b, tenant=tenant_of(s))
           for s, b in lost]
    hs.append(fe.submit_rebuild(parity))
    hs.append(fe.submit_scrub(metas))
    fe.flush()
    hs += [fe.submit_degraded_read(metas[s], b, tenant=tenant_of(s + 1))
           for s, b in lost]                          # cache hits
    hs += [fe.submit_client_read(m, tenant="gold") for m in metas]
    fe.drain()
    return hs


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_frontend_matches_reference(shards):
    """Results, shed decisions, per-class `ClassStats` (launches, bytes,
    virtual latencies, deadline misses, cache hits), hazard-checked
    flushes and cache stats equal the reference's for 1, 2 and 4 shards;
    submitted == served + shed per class."""
    S = 4
    b = _data_block()
    lost = [(0, b), (1, b)]

    def run(pkg):
        port = pkg == "port"
        mod = pr if port else ref_pr
        store, codec, metas = _port(S) if port else _ref(S, backend="kernels")
        for s, blk in lost:
            store.drop_block(s, blk)
        parity = [(1, CODE.k), (2, CODE.k + 1)]
        for s, blk in parity:
            store.drop_block(s, blk)
        Clock = VirtualClock if port else RefClock
        clocks = [Clock() for _ in range(shards)]
        adm = mod.AdmissionController(mod.QoSConfig(
            background_watermark=64, degraded_watermark=256,
            tenant_rate=200.0, tenant_burst=20.0,
            deadline_s={mod.Priority.CLIENT_READ: 1e-3}), clock=clocks[0])
        fe = (ShardedFrontend if port else RefSharded)(
            codec, num_shards=shards, background_ops_per_flush=4,
            cache=(HotBlockCache if port else RefCache)(16),
            admission=adm, clock_factory=lambda i: clocks[i],
            service_model=(ServiceModel if port else RefServiceModel)(),
            analyze_flushes=True)
        with fe:
            hs = _serve_script(fe, metas, lost, parity,
                               lambda i: ("gold", "free")[i % 2])
            out = ([_outcome(h) for h in hs], _stats(fe.stats),
                   fe.hazard_checked_flushes,
                   dataclasses.asdict(fe.cache.stats),
                   [c() for c in clocks])
        return out, hs

    (got, hs), (want, _) = run("port"), run("ref")
    assert got[:4] == want[:4]
    assert all(abs(a - b) <= RTOL * max(a, b)
               for a, b in zip(got[4], want[4]))
    outcomes, stats, hazard_flushes = got[:3]
    assert hazard_flushes > 0 and stats[2]["launches"] > 0
    submitted = {p: 0 for p in range(3)}
    for h in hs:              # a merged request is one request per shard
        submitted[int(h.priority)] += len(getattr(h, "_children", [h]))
    for p, cls in stats.items():
        assert cls["requests"] + cls["shed_requests"] == submitted[p]
    assert stats[int(Priority.DEGRADED_READ)]["cache_hits"] > 0
    assert any(o[0] == "shed" for o in outcomes)


def test_rebuild_report_matches_reference():
    b = _data_block()
    ports, refs = _port(), _ref(backend="kernels")
    reports = []
    for (store, codec, _), Fe in ((ports, RequestFrontend),
                                  (refs, RefFrontend)):
        node = store.node_of(1, b)
        store.fail_node(node)
        pairs = sorted(store.blocks_on_node(node))
        reports.append(dataclasses.asdict(Fe(codec).rebuild(
            pairs, exclude_node=node)))
    assert reports[0] == reports[1] and reports[0]["placed"] > 0
    assert sorted(ports[0]._block_node.items()) == \
        sorted(refs[0]._block_node.items())


def test_parallel_shard_flush_attribution_is_exact():
    """Concurrent shard flushes through one shared `TorchBackend` neither
    bleed nor double-count launches: the merged per-class count equals
    the global counter's delta for the whole drain."""
    b = _data_block()
    store, codec, metas = _port(6)
    lost = [(s, b) for s in range(6)]
    for s, blk in lost:
        store.drop_block(s, blk)
    with ShardedFrontend(codec, num_shards=3) as fe:
        hs = [fe.submit_degraded_read(metas[s], blk) for s, blk in lost]
        snap = ops.kernel_launch_snapshot()
        fe.drain()
        attributed = fe.stats[Priority.DEGRADED_READ].launches
    assert attributed == ops.launches_since(snap) == 3    # one per shard
    assert [h.result() for h in hs] == [
        _payload(0, 6)[(s * CODE.k + blk) * BS:(s * CODE.k + blk + 1) * BS]
        for s, blk in lost]


@pytest.mark.parametrize("chunk", [None, 100])
def test_backend_is_safe_under_concurrent_flushes(chunk):
    """Many threads encoding through one `TorchBackend`, with whole-call
    staging chunks or with chunks smaller than one call: every result is
    the host oracle's and the shared timing totals add up."""
    backend, host = TorchBackend("cpu"), NumpyBackend()
    if chunk is not None:
        backend.staging_chunk = chunk
    rng = np.random.default_rng(4)
    data = [rng.integers(0, 256, (2, CODE.k, 96), dtype=np.uint8)
            for _ in range(8)]
    want = [host.encode_many(CODE, d) for d in data]
    got: dict[int, list] = {}

    def worker(i):
        out = []
        for _ in range(5):
            out.append(backend.encode_many(CODE, data[i]))
            lazy = backend.encode_many_lazy(CODE, data[i])
            out.append(np.array(backend.force(lazy)))
        got[i] = out

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(8):
        assert all(np.array_equal(x, want[i]) for x in got[i])
    times = backend.take_times()
    assert times["stage_s"] > 0 and times["kernel_ms"] == 0.0


@pytest.mark.parametrize("chunk", [1, 7, 96, 1000, 1 << 20])
def test_backend_staging_in_chunks_matches_the_oracle(chunk):
    """Calls whose inputs and results are larger than one staging chunk
    stream through the two chunks each way: every result is the host
    oracle's, byte for byte, whether a chunk cuts inside one array or
    spans several."""
    from repro_torch.core.codec import decode_plan, single_recovery_plan

    backend, host = TorchBackend("cpu"), NumpyBackend()
    backend.staging_chunk = chunk
    rng = np.random.default_rng(chunk)
    S, B = 3, 97

    def blocks(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    data = blocks(S, CODE.k, B)
    cw = host.encode_many(CODE, data)
    assert np.array_equal(backend.encode_many(CODE, data), cw)
    plan = single_recovery_plan(CODE, _data_block(1))
    stacked = {s: cw[:, s] for s in plan.sources}
    assert np.array_equal(backend.recover_many(plan, stacked),
                          host.recover_many(plan, stacked))
    dplan = decode_plan(CODE, (0, _data_block(1), CODE.k))
    stacked = {s: cw[:, s] for s in dplan.sources}
    got, want = (b.apply_decode_many(dplan, stacked)
                 for b in (backend, host))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[e], want[e]) for e in want)
    M, deltas = blocks(4, 5), blocks(5, B)
    assert np.array_equal(backend.delta_terms(M, deltas),
                          host.delta_terms(M, deltas))
    folds = blocks(S, 5, B)
    assert np.array_equal(backend.xor_fold_many(folds),
                          host.xor_fold_many(folds))
    # the staging chunks are the only host buffers the calls kept
    chunks = backend._thread_ring().chunks
    assert [[c.numel() for c in pair] for pair in chunks.values()] == \
        [[chunk, chunk]] * 2


# ---------------------------------------------------------------------------
# The open loop under virtual time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["failure_free", "one_failed", "storm"])
def test_drive_open_loop_matches_reference(scenario):
    """A small `fig_saturation`-shaped run (Zipf 0.9, three tenants,
    4 shards, QoS, hot-block cache, metered rebuild storm, analysed
    flushes) gives the same arrivals, completions and latencies as the
    reference."""
    S, shards = 8, 4

    def run(pkg):
        port = pkg == "port"
        mod = pr if port else ref_pr
        store, codec, metas = (_port(S, backend=NumpyBackend()) if port
                               else _ref(S))
        lost_data, parity, failed = {}, [], -1
        if scenario != "failure_free":
            failed = store.node_of(metas[0].stripe_id, 0)
            held = store.blocks_on_node(failed)
            lost_data = {s: b for s, b in held if b < CODE.k}
            parity = sorted((s, b) for s, b in held if b >= CODE.k)
            store.fail_node(failed)
        Clock = VirtualClock if port else RefClock
        clocks = [Clock() for _ in range(shards)]
        adm = mod.AdmissionController(mod.QoSConfig(
            background_watermark=64, degraded_watermark=256,
            tenant_rate=90_000.0, tenant_burst=3_000.0,
            deadline_s={mod.Priority.CLIENT_READ: 0.004}), clock=clocks[0])
        fe = (ShardedFrontend if port else RefSharded)(
            codec, num_shards=shards, background_ops_per_flush=4,
            cache=(HotBlockCache if port else RefCache)(4 * S),
            admission=adm, clock_factory=lambda i: clocks[i],
            service_model=(ServiceModel if port else RefServiceModel)(
                per_launch_s=200e-6), analyze_flushes=True)
        wl = (ZipfWorkload if port else RefZipf)(
            num_stripes=S, rate_rps=8_000, duration_s=0.02, theta=0.9,
            tenants=("gold", "silver", "free"),
            tenant_weights=(0.5, 0.3, 0.2), seed=1)
        arrivals = wl.arrivals()

        def submit(a):
            if a.stripe in lost_data:
                return fe.submit_degraded_read(metas[a.stripe],
                                               lost_data[a.stripe],
                                               tenant=a.tenant)
            return fe.submit_client_read(metas[a.stripe], tenant=a.tenant)

        tick = [0]

        def on_tick(t):
            tick[0] += 1
            if scenario != "storm" or t > 0.02 or tick[0] % 8:
                return None
            for s, b in parity:
                store.drop_block(s, b)
            h = fe.submit_rebuild(parity, exclude_node=failed)
            return [(h, t, parity[0][0] % shards)]

        records = (drive_open_loop if port else ref_drive)(
            fe, arrivals, submit, clocks=clocks, num_shards=shards,
            tick_s=0.002, on_tick=on_tick)
        stats = _stats(fe.stats)
        fe.close()
        return ([(a.t, a.stripe, a.tenant) for a in arrivals],
                [(r.arrival_t, r.completion_t, int(r.priority), r.kind,
                  r.nbytes, r.shed, r.failed, r.latency_s)
                 for r in records], stats)

    got, want = run("port"), run("ref")
    assert got[0] == want[0] and len(got[0]) > 100
    assert got[2] == want[2]
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a[2:7] == b[2:7]
        assert all(abs(x - y) <= RTOL * max(abs(x), abs(y))
                   for x, y in zip(a[:2] + a[7:], b[:2] + b[7:]))


def test_virtual_clock_and_service_model_match():
    clock, rclock = VirtualClock(), RefClock()
    for dt in (0.0, 0.25, 1e-6):
        assert clock.advance(dt) == rclock.advance(dt)
    assert clock.set_at_least(0.1) == rclock.set_at_least(0.1)
    with pytest.raises(ValueError):
        clock.advance(-1.0)
    sample = type("S", (), dict(requests=3, launches=2, inner_bytes=4096,
                                cross_bytes=512))()
    assert ServiceModel()(sample) == RefServiceModel()(sample)


# ---------------------------------------------------------------------------
# The hazard analyser
# ---------------------------------------------------------------------------

def _verdicts(violations):
    return [(v.kind, v.loc, v.first, v.second, v.wave) for v in violations]


def _toy(mod, index=0, stripe=0, block=2, parities=(12, 16)):
    fp = ((stripe, block), *((stripe, p) for p in parities))
    return mod.OpAccess(index, "update", stripe, block, reads=fp, writes=fp)


def _schedules(mod):
    """The hand-built schedules of the reference's analyser tests."""
    op = _toy(mod)
    stale = mod.Wave(0, (op,), (
        mod.Step(0, "write", (0, 2)), mod.Step(0, "read", (0, 2)),
        mod.Step(0, "read", (0, 12)), mod.Step(0, "write", (0, 12)),
        mod.Step(0, "read", (0, 16)), mod.Step(0, "write", (0, 16))))
    late = mod.Wave(1, (op,), (
        mod.Step(0, "read", (0, 2)), mod.Step(0, "write", (0, 2)),
        mod.Step(0, "read", (0, 12)), mod.Step(0, "write", (0, 12))))
    twin = _toy(mod, index=1)
    return {
        "stale-parity": mod.FlushSchedule((), (stale,)),
        "late-read": mod.FlushSchedule((), (late,)),
        "staged": mod.FlushSchedule((), (mod.staged_wave(0, (op,)),)),
        "sibling-conflict": mod.FlushSchedule(
            (), (mod.staged_wave(0, (op, twin)),)),
        "reorder": mod.FlushSchedule((), (mod.staged_wave(0, (twin,)),
                                          mod.staged_wave(1, (op,)))),
        "writing-prelude": mod.FlushSchedule((op,), ()),
    }


@pytest.mark.parametrize("name", ["stale-parity", "late-read", "staged",
                                  "sibling-conflict", "reorder",
                                  "writing-prelude"])
def test_hazard_verdicts_match_on_hand_built_schedules(name):
    got = _verdicts(hz.check_schedule(_schedules(hz)[name]))
    want = _verdicts(ref_hz.check_schedule(_schedules(ref_hz)[name]))
    assert got == want
    assert bool(got) == (name != "staged")
    if name == "stale-parity":
        assert ("read-after-write", (0, 2)) in [v[:2] for v in got]


def _queue(engine, store, workload):
    if workload == "coalescer":
        engine.submit_read(2, 0)
        engine.submit_update(0, 0, bytes(BS))
        engine.submit_update(0, 1, bytes(BS))        # same stripe: wave 2
        engine.submit_update(2, 3, b"\x05" * BS)
        engine.submit_update(1, 0, b"\x09" * BS, reader_cluster=1)
    elif workload == "degraded":
        store.fail_node(store.node_of(1, 2))
        engine.submit_recover(1, 2)
        engine.submit_update(0, 0, bytes(BS))
    elif workload == "slow-path":
        grp = next(g for g in CODE.groups if 1 in g)
        other = next(x for x in grp if x != 1)
        store.fail_node(store.node_of(0, other))
        engine.submit_recover(0, 1)
        engine.submit_encode(np.zeros((1, CODE.k, BS), np.uint8))
    elif workload == "fanout":
        for sid in range(3):
            engine.submit_update(sid, sid % CODE.k, bytes(BS))
        engine.submit_update(0, 2, b"\x01" * BS)


@pytest.mark.parametrize("workload", ["coalescer", "degraded", "slow-path",
                                      "fanout"])
def test_flush_analyze_matches_reference(workload):
    """`analyze_flush` reports the same schedule (ops, waves, footprints,
    verdicts) on both packages' engines, and `flush(analyze=True)` then
    executes exactly what an unanalysed flush does."""
    pstore, pcodec, _ = _port(backend=NumpyBackend())
    rstore, rcodec, _ = _ref()
    _queue(pcodec.engine, pstore, workload)
    _queue(rcodec.engine, rstore, workload)
    got = hz.analyze_flush(pcodec.engine)
    want = ref_hz.analyze_flush(rcodec.engine)
    assert got.to_dict() == want.to_dict() and got.ok
    sched = hz.flush_schedule(pcodec.engine)
    rsched = ref_hz.flush_schedule(rcodec.engine)
    assert [(a.kind, a.reads, a.writes) for a in sched.prelude] == \
        [(a.kind, a.reads, a.writes) for a in rsched.prelude]
    handles = [op.handle for op in pcodec.engine._pending]
    rhandles = [op.handle for op in rcodec.engine._pending]
    stats = pcodec.engine.flush(analyze=True)
    rstats = rcodec.engine.flush(analyze=True)
    assert stats.update_waves == rstats.update_waves == got.waves

    def results(hs):
        return [np.asarray(h.result()).tobytes()
                if isinstance(h.result(), np.ndarray) else h.result()
                for h in hs]
    assert results(handles) == results(rhandles)
    assert pstore._blocks == rstore._blocks
    assert pstore._block_node == rstore._block_node


def test_flush_analyze_raises_before_executing(monkeypatch):
    """A queue the analyser rejects raises `HazardViolation` and executes
    nothing."""
    store, codec, _ = _port(backend=NumpyBackend())
    before = dict(store._blocks)
    codec.engine.submit_update(0, 0, b"\x07" * BS)
    real = hz.check_schedule

    def stale(sched):             # as if the wave read after writing
        return real(sched) + [hz.HazardViolation(
            "read-after-write", (0, 0), "op#0 update (write)",
            "op#0 update (stale read)", 0)]
    monkeypatch.setattr(hz, "check_schedule", stale)
    with pytest.raises(hz.HazardViolation, match="read-after-write"):
        codec.engine.flush(analyze=True)
    assert store._blocks == before


# ---------------------------------------------------------------------------
# cached == uncached, seeded scripts (the hypothesis property's scripts,
# drawn with numpy)
# ---------------------------------------------------------------------------

def _script(seed: int) -> list[tuple]:
    rng = np.random.default_rng(100 + seed)
    ops_ = []
    for _ in range(int(rng.integers(4, 13))):
        kind = ("degraded", "client", "update", "rebuild",
                "overwrite")[int(rng.integers(0, 5))]
        if kind == "degraded":
            ops_.append((kind, int(rng.integers(0, 3)),
                         int(rng.integers(0, CODE.k))))
        elif kind == "client":
            ops_.append((kind, int(rng.integers(0, 3))))
        elif kind == "update":
            ops_.append((kind, int(rng.integers(0, 3)),
                         int(rng.integers(0, CODE.k)),
                         int(rng.integers(0, 256))))
        elif kind == "rebuild":
            ops_.append((kind,))
        else:
            ops_.append((kind, int(rng.integers(0, 3)),
                         int(rng.integers(0, 256))))
    # every script reads the lost block at least once
    return [("degraded", 0, _data_block())] + ops_


def _run_script(pkg: str, cached: bool, seed: int, script) -> list[bytes]:
    port = pkg == "port"
    store, codec, metas = (_port(seed=seed % 4) if port
                           else _ref(seed=seed % 4))
    b = _data_block()
    for sid in range(3):
        store.drop_block(sid, b)
    cache = ((HotBlockCache if port else RefCache)(4) if cached else None)
    fe = (RequestFrontend if port else RefFrontend)(
        codec, cache=cache, analyze_flushes=True)
    out, handles = [], []

    def drain():
        fe.drain()
        out.extend(h.result() for h in handles)
        handles.clear()

    for op in script:
        if op[0] == "degraded":
            _, sid, blk = op
            if not store.available(sid, blk):
                handles.append(fe.submit_degraded_read(metas[sid], blk))
        elif op[0] == "client":
            handles.append(fe.submit_client_read(metas[op[1]]))
        elif op[0] == "update":
            _, sid, blk, fill = op
            if store.available(sid, blk):
                drain()
                codec.update_block(metas[sid], blk, bytes([fill]) * BS)
        elif op[0] == "rebuild":
            drain()
            pairs = [(sid, blk) for sid in range(3) for blk in range(CODE.n)
                     if not store.available(sid, blk)]
            if pairs:
                codec.rebuild_blocks(pairs)
        else:
            _, sid, fill = op
            drain()
            codec.write(bytes([fill]) * (CODE.k * BS), start_stripe=sid)
            store.drop_block(sid, b)
    drain()
    return out


@pytest.mark.parametrize("seed", range(10))
def test_cached_equals_uncached_seeded(seed):
    script = _script(seed)
    cached = _run_script("port", True, seed, script)
    assert cached == _run_script("port", False, seed, script)
    assert cached == _run_script("ref", False, seed, script)
    assert cached
