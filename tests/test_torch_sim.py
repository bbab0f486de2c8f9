"""The port's failure/repair simulator (`repro_torch.sim`) against the
reference's (`repro.sim`), on the CPU.

Both packages get the same inputs. The event core, the scheduler's ledgers
and job orders, and the Monte Carlo drivers must agree exactly: the port
keeps every float sum and comparison in the reference's order. The port
cannot replay JAX's random stream, so the drivers are compared given the
reference's own initial-lifetime matrix (injected in place of the port's
`sample_lifetimes`); the port's sampler is checked on its own, by
determinism and a Kolmogorov-Smirnov test. Quantiles: numpy exactly equal,
torch float32 within rtol = 1e-6 of jnp float32 on the same uniforms.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import sim as R
from repro.ckpt import BlockStore as RefStore
from repro.ckpt.stripe import StripeCodec as RefCodec
from repro.core import make_alrc as ref_make_alrc
from repro.core import make_rs as ref_make_rs
from repro.core import make_unilrc as ref_make_unilrc
from repro.core.mttdl import MTTDLParams as RefParams
from repro.core.placement import default_placement as ref_default_placement
from repro.kernels import ops as ref_ops
from repro.topo import Topology as RefTopology
from repro_torch import sim as T
from repro_torch.ckpt import BlockStore, StripeCodec
from repro_torch.core import (MTTDLParams, code_from_state,
                              effective_recovery_traffic, locality_metrics,
                              make_rs, tolerable_failures)
from repro_torch.core.placement import default_placement
from repro_torch.io import TorchBackend
from repro_torch.kernels import ops
from repro_torch.sim import montecarlo as tmc
from repro_torch.topo import Topology

STRESS = dict(N=4, S_TB=1.0, epsilon=0.0017, delta=0.5, T_hours=300.0,
              B_Gbps=1.0, node_mttf_years=0.5)
MILD = dict(N=4, S_TB=1.0, epsilon=0.05, delta=0.5, T_hours=48.0,
            B_Gbps=1.0, node_mttf_years=0.5)


def _port(ref_code):
    """The port's copy of a reference code, carried over by state."""
    return code_from_state(ref_code.name, ref_code.n, ref_code.k, ref_code.A,
                           ref_code.groups, ref_code.checks,
                           ref_code.block_type, ref_code.meta)


def _asdict(obj) -> dict:
    """A ledger / report / estimate as plain values: Priority keys (one
    enum per package) become ints, Counters become dicts."""
    out = {}
    for field in dataclasses.fields(obj):
        key, value = field.name, getattr(obj, field.name)
        if isinstance(value, dict):
            value = {int(k) if not isinstance(k, str) else k: v
                     for k, v in value.items()}
        out[key] = value
    return out


# ---------------------------------------------------------------------------
# Event core
# ---------------------------------------------------------------------------

def _queue_trace(pkg, seed: int) -> list:
    rng = random.Random(seed)
    q = pkg.EventQueue()
    handles, trace = [], []
    for _ in range(300):
        op = rng.random()
        if op < 0.5:
            # coarse times so that ties are common
            handles.append(q.push(rng.randrange(20) / 4, "k", i=len(handles)))
        elif op < 0.7 and handles:
            q.cancel(rng.choice(handles))
        elif op < 0.9:
            ev = q.pop()
            trace.append(None if ev is None else
                         (ev.time, ev.seq, ev.kind, ev.payload["i"]))
        else:
            trace.append(("peek", q.peek_time(), len(q)))
    while (ev := q.pop()) is not None:
        trace.append((ev.time, ev.seq, ev.kind, ev.payload["i"]))
    return trace


def _sim_trace(pkg, seed: int) -> list:
    """Handlers that schedule, cancel and stop, run to a horizon and a
    budget, then drained."""
    rng = random.Random(seed)
    sim = pkg.Simulator()
    trace, live = [], []

    def on_tick(s, ev):
        trace.append((s.now, ev.seq, "tick", ev.payload["n"]))
        for _ in range(rng.randrange(3)):
            live.append(s.schedule(rng.randrange(8) / 2, "tick",
                                   n=ev.payload["n"] + 1))
        if live and rng.random() < 0.3:
            s.cancel(live.pop(rng.randrange(len(live))))
        if rng.random() < 0.05:
            s.stop()

    sim.on("tick", on_tick)
    for i in range(5):
        live.append(sim.schedule_at(i / 2, "tick", n=0))
    trace.append(("run", sim.run(until=6.0)))
    trace.append(("run", sim.run(max_events=40)))
    trace.append(("run", sim.run(max_events=400), sim.events_handled))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_event_traces_identical(seed):
    assert _queue_trace(T, seed) == _queue_trace(R, seed)
    assert _sim_trace(T, seed) == _sim_trace(R, seed)


def test_event_errors_identical():
    for pkg in (R, T):
        sim = pkg.Simulator()
        with pytest.raises(ValueError, match="past"):
            sim.schedule(-1.0, "x")
        sim.on("x", lambda s, e: None)
        with pytest.raises(ValueError, match="already registered"):
            sim.on("x", lambda s, e: None)
        sim.schedule(1.0, "nobody")
        with pytest.raises(KeyError, match="nobody"):
            sim.run()
        with pytest.raises(ValueError, match=">= 0"):
            pkg.EventQueue().push(-0.5, "x")


# ---------------------------------------------------------------------------
# Hazards and the sampler
# ---------------------------------------------------------------------------

HAZARDS = [("Exponential", (4380.0,)), ("Weibull", (0.7, 4000.0)),
           ("Weibull", (2.0, 50.0)), ("Weibull", (1.0, 100.0))]


@pytest.mark.parametrize("kind,args", HAZARDS)
def test_quantiles_match_reference(kind, args):
    ref, port = getattr(R, kind)(*args), getattr(T, kind)(*args)
    u = np.random.default_rng(0).random(4096)
    assert np.array_equal(port.quantile(u), ref.quantile(u))
    assert port.mean_hours == ref.mean_hours
    u32 = u.astype(np.float32)
    want = np.asarray(ref.quantile(jnp.asarray(u32)))
    got = port.quantile(torch.from_numpy(u32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    rng_r, rng_p = np.random.default_rng(5), np.random.default_rng(5)
    assert np.array_equal(port.sample(rng_p, 64), ref.sample(rng_r, 64))


def test_failure_model_draws_match_reference():
    for mean in (None, 100.0):
        ref = R.FailureModel(R.Exponential(10.0), cluster_loss_mean_hours=mean)
        port = T.FailureModel(T.Exponential(10.0),
                              cluster_loss_mean_hours=mean)
        rng_r, rng_p = np.random.default_rng(1), np.random.default_rng(1)
        for _ in range(20):
            assert (port.next_cluster_loss(rng_p)
                    == ref.next_cluster_loss(rng_r))
            assert port.pick_cluster(rng_p, 7) == ref.pick_cluster(rng_r, 7)
    assert (T.exponential_from_mttf_years(0.5)
            == T.Exponential(R.exponential_from_mttf_years(0.5).mean))


def _gen(seed):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


def test_sampler_deterministic_shape_and_dtype():
    haz = T.exponential_from_mttf_years(1.0)
    a = T.sample_lifetimes(haz, _gen(7), (5, 16), device="cpu")
    b = T.sample_lifetimes(haz, _gen(7), (5, 16), device="cpu")
    c = T.sample_lifetimes(haz, _gen(8), (5, 16), device="cpu")
    assert a.shape == (5, 16) and a.dtype == np.float64
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (a >= 0).all()


@pytest.mark.parametrize("kind,args", HAZARDS[:2])
def test_sampler_distribution_ks(kind, args):
    """n = 200,000 float32 inverse-CDF draws against the exact CDF."""
    haz = getattr(T, kind)(*args)
    x = T.sample_lifetimes(haz, _gen(11), (200_000,), device="cpu")
    if kind == "Exponential":
        cdf = stats.expon(scale=args[0]).cdf
    else:
        cdf = stats.weibull_min(args[0], scale=args[1]).cdf
    assert stats.kstest(x, cdf).pvalue > 1e-3


def test_drivers_raise_without_a_card_when_no_device_is_given():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    params = MTTDLParams(**STRESS)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.sample_lifetimes(T.Exponential(1.0), _gen(0), (2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.simulate_stripe_mttdl(12, 4, 5.0, params, trials=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_campaign(T.SimConfig(code=_port(ref_make_unilrc(1, 2)),
                                   params=params, trials=1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.sample_lifetimes(T.Exponential(1.0), _gen(0), (2,), device="meta")


# ---------------------------------------------------------------------------
# Repair scheduler: every scenario of the reference's tests, both packages
# ---------------------------------------------------------------------------

def _uni14():
    code = ref_make_unilrc(1, 4)
    return code, ref_default_placement(code)


def _scenarios():
    """name -> (reference code, pairs, missing, block_TB). `missing` is
    "single" (every stripe one block down, the reference's stub), "live"
    (what is damaged and not yet repaired) or a fixed map."""
    code, pl = _uni14()
    grp = code.groups[0]
    c0, c1 = sorted(pl.cluster_blocks(0)), sorted(pl.cluster_blocks(1))
    out = {
        "single_duration": (code, [(0, 3)], "single", 0.25),
        "multi_detection": (code, [(0, 3), (0, 7)], {0: {3, 7}}, 0.25),
        "group_by_plan": (code, [(0, 2), (1, 2), (2, 2), (0, 9)], "single",
                          0.25),
        "alrc_all_blocks": (ref_make_alrc(k=4, l=2, g=2),
                            [(0, b) for b in range(8)], "single", 0.25),
        "in_group_double": (code, [(0, grp[0]), (0, grp[1])],
                            {0: {grp[0], grp[1]}}, 0.25),
        "disjoint": (code, [(0, c0[0]), (1, c1[0])], "live", 0.25),
        "shared": (code, [(0, c0[0]), (1, c0[1])], "live", 0.25),
        "detection_limited": (code, [(sid, b) for sid in range(3)
                                     for b in c0], "live", 0.002),
        "multi_before_single": (code, [(0, c0[0]), (1, c1[0]), (1, c1[1])],
                                "live", 0.25),
        "pipe_frozen_order": (code, [(0, 7), (1, 2), (2, 3), (2, 4)],
                              {2: {3, 4}}, 0.25),
    }
    for seed in range(4):
        rng = random.Random(seed)
        out[f"random_{seed}"] = (code, sorted(
            {(rng.randrange(4), rng.randrange(code.n))
             for _ in range(rng.randrange(2, 12))}), "live", 0.25)
    return out


SCENARIOS = _scenarios()
MODES = ["pipe", "link", "link_serial"]


def _drive(pkg, code, pairs, missing_kind, block_TB, mode, *, codec=None):
    """One scheduler over `pairs` in `pkg`; returns the job log, the
    healed order, the ledger and the clock."""
    topo_cls = RefTopology if pkg is R else Topology
    params_cls = RefParams if pkg is R else MTTDLParams
    placement = (codec.placement if codec is not None else
                 (ref_default_placement(code) if pkg is R
                  else default_placement(code)))
    topo = (topo_cls(placement.num_clusters, 8) if mode != "pipe"
            else None)
    sim = pkg.Simulator()
    live: dict[int, set[int]] = {}
    for sid, b in pairs:
        live.setdefault(sid, set()).add(b)

    if missing_kind == "single":
        def missing(sid):
            return frozenset({-1})
    elif missing_kind == "live":
        def missing(sid):
            return live.get(sid, frozenset())
    elif missing_kind == "store":
        def missing(sid):
            return frozenset(b for b in range(code.n)
                             if not codec.store.available(sid, b))
    else:
        def missing(sid):
            return missing_kind.get(sid, frozenset({-1}))
    healed, log = [], []

    def on_repaired(done):
        for sid, b in done:
            live.get(sid, set()).discard(b)
        healed.extend(done)

    class Observer:
        def admitted(self, group, tier, hours, bottleneck, rates):
            log.append(("admit", sim.now, sorted(group), int(tier), hours,
                        bottleneck, sorted(rates.items())))

        def completed(self, group):
            log.append(("done", sim.now, sorted(group)))

    sched = pkg.RepairScheduler(
        sim, placement, params_cls(), block_TB=block_TB,
        stripe_missing=missing, on_repaired=on_repaired, codec=codec,
        topology=topo, max_inflight=1 if mode == "link_serial" else None,
        observer=Observer())
    sched.damaged(list(pairs))
    end = sim.run()
    return log, healed, _asdict(sched.ledger), end


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_ledgers_and_job_orders_identical(name, mode):
    ref_code, pairs, missing, block_TB = SCENARIOS[name]
    want = _drive(R, ref_code, pairs, missing, block_TB, mode)
    got = _drive(T, _port(ref_code), pairs, missing, block_TB, mode)
    assert got == want
    assert want[2]["repaired_blocks"] == len(pairs)


def test_scheduler_rejections_identical():
    code, pl = _uni14()
    errors = []
    for pkg, placement, topo_cls, params in (
            (R, pl, RefTopology, RefParams()),
            (T, default_placement(_port(code)), Topology, MTTDLParams())):
        kw = dict(block_TB=0.25, stripe_missing=lambda sid: frozenset({-1}),
                  on_repaired=lambda pairs: None)
        for extra in (dict(max_inflight=4),
                      dict(topology=topo_cls(4, 8), max_inflight=0)):
            with pytest.raises(ValueError) as err:
                pkg.RepairScheduler(pkg.Simulator(), placement, params,
                                    **kw, **extra)
            errors.append(str(err.value))
    assert errors[:2] == errors[2:]


def test_node_repair_hours_identical():
    for C in (1.0, 5.5, 21.0):
        assert (T.node_repair_hours(C, MTTDLParams(**MILD))
                == R.node_repair_hours(C, RefParams(**MILD)))


# ---------------------------------------------------------------------------
# Data-path scheduling: real bytes through both front-ends
# ---------------------------------------------------------------------------

def _codecs(S: int, seed: int):
    code = ref_make_unilrc(1, 4)
    ref = RefCodec(code, RefStore(RefTopology(4, 8)), block_size=512)
    port = StripeCodec(_port(code), BlockStore(Topology(4, 8)),
                       block_size=512, backend=TorchBackend("cpu"))
    payload = np.random.default_rng(seed).integers(
        0, 256, code.k * 512 * S, np.uint8).tobytes()
    return code, ref, port, payload


def _data_path_run(pkg, codec, payload, damage, missing_kind, mode):
    counters = ref_ops if pkg is R else ops
    metas = codec.write(payload)
    pairs = damage(codec.store)
    counters.reset_kernel_launch_counts()
    out = _drive(pkg, codec.code, pairs, missing_kind, 0.25, mode,
                 codec=codec)
    launches = sum(counters.KERNEL_LAUNCHES.values())
    counters.reset_kernel_launch_counts()
    return out, launches, codec.read_all(metas) == payload


def _node_loss(store):
    victim = store.topo.node_of(2, 1)
    pairs = store.blocks_on_node(victim)
    store.fail_node(victim)
    return pairs


def _pattern_loss(store, code, S):
    b1, b2 = [b for b in code.groups[0] if code.block_type[b] == "d"][:2]
    for sid in range(S):
        store.drop_block(sid, b1)
        store.drop_block(sid, b2)
    return [(sid, b) for sid in range(S) for b in (b1, b2)]


@pytest.mark.parametrize("mode", ["pipe", "link"])
@pytest.mark.parametrize("damage", ["node", "pattern"])
def test_data_path_scheduler_identical(damage, mode):
    """The reference's two data-path scheduler tests (a node's blocks on
    the XOR fast path; a shared two-erasure pattern across 6 stripes in
    one pattern decode) through both packages: ledgers, job orders,
    launches and the bytes read back are equal."""
    S = 12 if damage == "node" else 6
    code, ref, port, payload = _codecs(S, 3 if damage == "node" else 7)
    results = []
    for pkg, codec in ((R, ref), (T, port)):
        if damage == "node":
            hit = _node_loss
            kind = "single"
        else:
            def hit(store, code=codec.code):
                return _pattern_loss(store, code, S)
            kind = "store"
        results.append(_data_path_run(pkg, codec, payload, hit, kind, mode))
    (want, want_launches, ref_ok), (got, got_launches, ok) = results
    assert got == want and got_launches == want_launches
    assert ok and ref_ok
    ledger = got[2]
    assert ledger["kernel_launches"] == ledger["plan_groups"] == got_launches
    if damage == "pattern":
        assert got_launches == 2 and ledger["multi_erasure_blocks"] == S


# ---------------------------------------------------------------------------
# Monte Carlo drivers, given the reference's initial lifetimes
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_lifetimes(monkeypatch):
    """Make the port's drivers start from the matrix the reference draws
    for the same hazard, seed and shape."""
    def inject(hazard, generator, shape, *, device):
        assert generator.device.type == "cpu" and device == "cpu"
        ref_hazard = getattr(R, type(hazard).__name__)(
            *dataclasses.astuple(hazard))
        return R.sample_lifetimes(ref_hazard,
                                  jax.random.PRNGKey(generator.initial_seed()),
                                  shape)
    monkeypatch.setattr(tmc, "sample_lifetimes", inject)


@pytest.mark.parametrize("make", [lambda: ref_make_unilrc(1, 2),
                                  lambda: ref_make_alrc(k=4, l=2, g=2)],
                         ids=["UniLRC", "ALRC"])
def test_simulate_stripe_mttdl_identical(ref_lifetimes, make):
    code = make()
    port = _port(code)
    C = effective_recovery_traffic(
        locality_metrics(port, default_placement(port)), STRESS["delta"])
    f = tolerable_failures(port)
    want = R.simulate_stripe_mttdl(code.n, f, C, RefParams(**STRESS),
                                   trials=120, seed=3)
    got = T.simulate_stripe_mttdl(code.n, f, C, MTTDLParams(**STRESS),
                                  trials=120, seed=3, device="cpu")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (T.markov_mttdl_years(port, default_placement(port),
                                 MTTDLParams(**STRESS))
            == R.markov_mttdl_years(code, ref_default_placement(code),
                                    RefParams(**STRESS)))


def _configs(code, *, params, topo=None, cluster_loss=None, **kw):
    """The same campaign in both packages."""
    port_code = _port(code)
    ref = R.SimConfig(
        code=code, params=RefParams(**params),
        failure_model=R.FailureModel(
            node=R.exponential_from_mttf_years(params["node_mttf_years"]),
            cluster_loss_mean_hours=cluster_loss),
        topology=None if topo is None else RefTopology(*topo), **kw)
    port = T.SimConfig(
        code=port_code, params=MTTDLParams(**params),
        failure_model=T.FailureModel(
            node=T.exponential_from_mttf_years(params["node_mttf_years"]),
            cluster_loss_mean_hours=cluster_loss),
        topology=None if topo is None else Topology(*topo), device="cpu",
        **kw)
    return ref, port


CAMPAIGNS = {
    "pipe_correlated": dict(code=lambda: ref_make_unilrc(1, 2),
                            params=STRESS, cluster_loss=3000.0, n_stripes=2,
                            trials=8, seed=0, mission_hours=5 * 8760.0),
    "link_correlated": dict(code=lambda: ref_make_unilrc(1, 3),
                            params=MILD, cluster_loss=1500.0, topo=(3, 8),
                            n_stripes=3, trials=4, seed=1,
                            mission_hours=1.5 * 8760.0),
    "link_serial_alrc": dict(code=lambda: ref_make_alrc(k=4, l=2, g=2),
                             params=MILD, topo=(3, 6), n_stripes=2,
                             trials=3, seed=2, mission_hours=2 * 8760.0,
                             max_inflight_repairs=1),
}


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_run_campaign_metadata_identical(ref_lifetimes, name):
    spec = dict(CAMPAIGNS[name])
    ref_cfg, port_cfg = _configs(spec.pop("code")(), **spec)
    want = R.run_campaign(ref_cfg)
    got = T.run_campaign(port_cfg)
    assert _asdict(got) == _asdict(want)
    assert got.repaired_blocks > 0


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_trials_identical(name):
    """Every `TrialResult`, each trial from its row of the reference's
    initial-lifetime matrix."""
    spec = dict(CAMPAIGNS[name])
    ref_cfg, port_cfg = _configs(spec.pop("code")(), **spec)
    nodes = (ref_cfg.resolved_placement().num_clusters
             * ref_cfg.resolved_npc())
    init = R.sample_lifetimes(ref_cfg.resolved_failure_model().node,
                              jax.random.PRNGKey(ref_cfg.seed),
                              (ref_cfg.trials, nodes))
    for t in range(ref_cfg.trials):
        want = R.DssTrial(ref_cfg, t, init[t]).run()
        got = T.DssTrial(port_cfg, t, init[t]).run()
        assert _asdict(got) == _asdict(want)


def test_data_path_campaign_identical(ref_lifetimes):
    """Data-path mode: real bytes repaired through the reference's kernels
    and the port's plain versions on `TorchBackend("cpu")`. Reports,
    launches and the payload read back are equal."""
    ref_cfg, port_cfg = _configs(
        ref_make_unilrc(1, 2), params=STRESS, n_stripes=3, trials=1, seed=5,
        mission_hours=2 * 8760.0, data_path=True, block_size=256)
    init = R.sample_lifetimes(ref_cfg.resolved_failure_model().node,
                              jax.random.PRNGKey(5), (1, 8))
    ref_ops.reset_kernel_launch_counts()
    ops.reset_kernel_launch_counts()
    ref_trial = R.DssTrial(ref_cfg, 0, init[0])
    trial = T.DssTrial(port_cfg, 0, init[0])
    assert trial.payload == ref_trial.payload
    want, got = ref_trial.run(), trial.run()
    assert _asdict(got) == _asdict(want)
    assert not got.lost and got.kernel_launches > 0
    assert trial.codec.read_all(trial.metas) == trial.payload
    assert (sum(ops.KERNEL_LAUNCHES.values())
            == sum(ref_ops.KERNEL_LAUNCHES.values()))
    assert (_asdict(trial.scheduler.ledger)
            == _asdict(ref_trial.scheduler.ledger))
    assert trial.codec.backend.device.type == "cpu"
    ref_ops.reset_kernel_launch_counts()
    ops.reset_kernel_launch_counts()
    assert (_asdict(T.run_campaign(port_cfg))
            == _asdict(R.run_campaign(ref_cfg)))


def test_make_rs_identical():
    ref, port = ref_make_rs(42, 30), make_rs(42, 30)
    assert (port.name, port.n, port.k, port.groups, port.block_type,
            port.meta) == (ref.name, ref.n, ref.k, ref.groups,
                           ref.block_type, ref.meta)
    assert np.array_equal(port.A, ref.A)
    assert np.array_equal(port.checks, ref.checks)
