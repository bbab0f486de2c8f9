"""Monte Carlo drivers: many independent trials of the event simulator.

Two levels of fidelity, one set of rates:

  * `simulate_stripe_mttdl` — the §5 Markov chain realized event-by-event
    (per-block exponential failures, rate-μ/μ' repairs). In the
    memoryless, uncorrelated regime this *is* the chain, so its estimate
    must land on `core.mttdl.mttdl_years_stripe` — the cross-validation
    tests/test_sim.py pins with a deterministic seed (and
    tests/test_torch_sim.py holds this copy to the reference).
  * `run_campaign` — the full deployment simulator: z clusters × nodes,
    stripes placed like `StripeCodec` (slot rotation), Weibull or
    exponential node hazards, optional correlated cluster-loss events,
    and the bandwidth-constrained plan-grouped `RepairScheduler`. This
    is where the Markov assumptions break and the divergence benchmark
    (benchmarks/fig_sim_reliability.py) gets its numbers.

Initial lifetimes for every (trial, node) come from ONE vectorized
torch draw on the campaign's device (`failures.sample_lifetimes`, a
`torch.Generator` seeded with the campaign seed); in-trial replacement
draws use per-trial numpy generators seeded from a SeedSequence, so
campaigns are deterministic per (seed, trial, device) regardless of trial
order, and two runs given the same initial-lifetime matrix follow the
same trajectories.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.codec import decode_plan_cached
from repro_torch.core.codes import Code
from repro_torch.core.metrics import locality_metrics
from repro_torch.core.mttdl import (MTTDLParams, effective_recovery_traffic,
                                    markov_rates, tolerable_failures)
from repro_torch.core.placement import Placement, default_placement
from repro_torch.device import resolve_device
from repro_torch.topo import Topology

from .events import Event, Simulator
from .failures import (FailureModel, exponential_from_mttf_years,
                       sample_lifetimes)
from .repair import RepairScheduler

HOURS_PER_YEAR = 24 * 365


def _initial_lifetimes(hazard, seed: int, shape: tuple[int, ...],
                       device: str | torch.device) -> np.ndarray:
    """Every trial's initial lifetimes in one draw on `device`, from a
    generator there seeded with `seed`."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return sample_lifetimes(hazard, gen, shape, device=device)


# ---------------------------------------------------------------------------
# Level 1: the Markov chain, event by event (cross-validation regime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MCEstimate:
    """Sample-mean estimate with a 95% normal confidence interval."""
    mean_years: float
    ci95_years: float          # half-width
    std_years: float
    trials: int

    def contains(self, value_years: float) -> bool:
        return abs(value_years - self.mean_years) <= self.ci95_years


def simulate_stripe_mttdl(code_n: int, f: int, C_blocks: float,
                          p: MTTDLParams, *, trials: int = 400,
                          seed: int = 0,
                          max_events_per_trial: int = 2_000_000,
                          device: str | torch.device = "cuda"
                          ) -> MCEstimate:
    """Event-driven realization of the §5 chain, `trials` absorption times.

    Each of the `code_n` live blocks fails at rate λ; with j ≥ 1 blocks
    down one repair is in flight at rate μ (j = 1) or μ' (j ≥ 2) —
    re-drawn on every state change, which is exact for exponentials.
    Absorption at j = f+1. Initial block lifetimes are one vectorized
    draw across all trials on `device` (CUDA unless the caller asks for
    the CPU; without a card the default raises)."""
    lam, mu, mu_p = markov_rates(C_blocks, p)
    haz = exponential_from_mttf_years(p.node_mttf_years)
    init = _initial_lifetimes(haz, seed, (trials, code_n), device)
    times = np.zeros(trials)
    for t in range(trials):
        rng = np.random.default_rng(np.random.SeedSequence([seed, t]))
        sim = Simulator()
        failed: list[int] = []
        repair_ev = [None]

        def resched_repair(sim=sim, failed=failed, repair_ev=repair_ev,
                           rng=rng):
            if repair_ev[0] is not None:
                sim.cancel(repair_ev[0])
                repair_ev[0] = None
            j = len(failed)
            if j == 0 or j > f:
                return
            rate = mu if j == 1 else mu_p
            repair_ev[0] = sim.schedule(rng.exponential(1.0 / rate), "repair")

        def on_fail(sim, ev, failed=failed, rng=rng):
            failed.append(ev.payload["block"])
            if len(failed) > f:            # absorption: data loss
                sim.stop()
                return
            resched_repair()

        def on_repair(sim, ev, failed=failed, rng=rng,
                      repair_ev=repair_ev):
            repair_ev[0] = None
            block = failed.pop()
            sim.schedule(rng.exponential(1.0 / lam), "fail", block=block)
            resched_repair()

        sim.on("fail", on_fail)
        sim.on("repair", on_repair)
        for b in range(code_n):
            sim.schedule_at(float(init[t, b]), "fail", block=b)
        sim.run(max_events=max_events_per_trial)
        if len(failed) <= f:
            raise RuntimeError(
                f"trial {t} hit max_events_per_trial before absorption — "
                f"rates too mild for simulation; stress the parameters")
        times[t] = sim.now
    yrs = times / HOURS_PER_YEAR
    mean = float(yrs.mean())
    std = float(yrs.std(ddof=1))
    return MCEstimate(mean, 1.96 * std / math.sqrt(trials), std, trials)


def markov_mttdl_years(code: Code, placement: Placement,
                       p: MTTDLParams) -> float:
    """The closed-form answer the simulator is validated against."""
    from repro_torch.core.mttdl import mttdl_years_stripe
    m = locality_metrics(code, placement)
    C = effective_recovery_traffic(m, p.delta)
    return mttdl_years_stripe(code.n, tolerable_failures(code), C, p)


# ---------------------------------------------------------------------------
# Level 2: full deployment campaign
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One Monte Carlo campaign over a simulated deployment."""
    code: Code
    params: MTTDLParams = MTTDLParams()
    placement: Placement | None = None      # default_placement(code)
    nodes_per_cluster: int = 0                 # 0 => max cluster load + 1
    n_stripes: int = 4
    mission_hours: float = 10 * HOURS_PER_YEAR
    trials: int = 20
    seed: int = 0
    failure_model: FailureModel | None = None   # default: exp from params
    data_path: bool = False                    # drive real bytes via codec
    block_size: int = 1 << 12                  # data-path block bytes
    max_events_per_trial: int = 500_000
    # Explicit link-tier topology: switches the repair scheduler from the
    # Markov-calibrated aggregate pipe to per-link bottleneck charging
    # (survivor uplinks + oversubscribed core). None keeps the chain's
    # pipe semantics; num_clusters/nodes_per_cluster must match the
    # placement's deployment when given.
    topology: Topology | None = None
    # Concurrent repair cap (link mode only): None = admission-limited,
    # 1 = the serialized baseline. The pipe mode is inherently serial
    # (one Markov repair server) and rejects any other value.
    max_inflight_repairs: int | None = None
    # Where the initial lifetimes are drawn and, in data-path mode, where
    # the codec's kernels run (`TorchBackend(device)`). CUDA unless the
    # caller asks for the CPU; without a card the default raises.
    device: str = "cuda"

    def resolved_placement(self) -> Placement:
        return self.placement or default_placement(self.code)

    def resolved_failure_model(self) -> FailureModel:
        return self.failure_model or FailureModel(
            node=exponential_from_mttf_years(self.params.node_mttf_years))

    def resolved_npc(self) -> int:
        if self.topology is not None:
            return self.topology.nodes_per_cluster
        if self.nodes_per_cluster:
            return self.nodes_per_cluster
        return max(self.resolved_placement().cluster_sizes()) + 1

    def resolved_topology(self) -> Topology:
        """The store/node topology of the trial (ALWAYS defined — link
        fields default to the paper's testbed when no explicit topology
        is configured)."""
        if self.topology is not None:
            return self.topology
        return Topology(self.resolved_placement().num_clusters,
                        self.resolved_npc())


@dataclasses.dataclass
class TrialResult:
    observed_hours: float
    lost: bool
    loss_hours: float | None
    degraded_fraction: float
    repaired_blocks: int
    cross_blocks_read: int
    inner_blocks_read: int
    kernel_launches: int
    repair_jobs: int


@dataclasses.dataclass(frozen=True)
class CampaignReport:
    """Aggregate over all trials of one SimConfig."""
    code: str
    placement: str
    trials: int
    losses: int
    total_hours: float
    mttdl_years: float | None       # total time / losses; None if 0 losses
    mttdl_lower_bound_years: float     # total time / max(losses, 1)
    loss_probability: float            # P(loss within mission_hours)
    degraded_fraction: float           # time-avg fraction of damaged stripes
    cross_traffic_fraction: float      # of repair reads, share cross-cluster
    repaired_blocks: int
    repair_jobs: int
    kernel_launches: int

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["mttdl_years"] = self.mttdl_years
        return d


class DssTrial:
    """One trial: z clusters × npc nodes, `n_stripes` stripes, an event
    loop wiring failures -> damage tracking -> RepairScheduler.

    Metadata mode tracks block availability only (fast, any scale);
    data-path mode (cfg.data_path) writes real payload through a
    StripeCodec on a BlockStore and repairs real bytes with the batched
    engine, so the kernel-launch ledger doubles as a plan-group oracle.
    """

    NODE_FAIL = "node_fail"
    CLUSTER_LOSS = "cluster_loss"

    def __init__(self, cfg: SimConfig, trial: int,
                 init_lifetimes: np.ndarray):
        self.cfg = cfg
        self.code = cfg.code
        self.placement = cfg.resolved_placement()
        self.model = cfg.resolved_failure_model()
        self.f = tolerable_failures(self.code)
        self.npc = cfg.resolved_npc()
        self.num_clusters = self.placement.num_clusters
        self.num_nodes = self.num_clusters * self.npc
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, trial]))
        self.sim = Simulator()
        self.sim.on(self.NODE_FAIL, self._on_node_fail)
        self.sim.on(self.CLUSTER_LOSS, self._on_cluster_loss)

        # block volume: a node's stripe-share sums to S_TB across stripes
        # (the Markov model's unit: repairing a whole node moves C·S).
        blocks_per_node = max(1, math.ceil(
            cfg.n_stripes * self.code.n / self.num_nodes))
        block_TB = cfg.params.S_TB / blocks_per_node

        self.missing: dict[int, set[int]] = {}
        self.lost_at: float | None = None
        self._degraded_acc = 0.0
        self._last_t = 0.0

        # An undersized explicit topology would silently wrap stripe
        # blocks onto shared nodes (a single node failure becomes a
        # multi-erasure) — the same invariant StripeCodec's constructor
        # enforces for the data path.
        need_npc = max(self.placement.cluster_sizes())
        if cfg.topology is not None and (
                cfg.topology.num_clusters < self.num_clusters
                or cfg.topology.nodes_per_cluster < need_npc):
            raise ValueError(
                f"SimConfig.topology is {cfg.topology.num_clusters}x"
                f"{cfg.topology.nodes_per_cluster} but the placement "
                f"needs {self.num_clusters} clusters of >= {need_npc} "
                f"nodes")
        self.topology = cfg.resolved_topology()

        self.codec = None
        self.payload = b""
        if cfg.data_path:
            from repro_torch.ckpt.store import BlockStore
            from repro_torch.ckpt.stripe import StripeCodec
            from repro_torch.io.backend import TorchBackend
            self.store = BlockStore(self.topology)
            self.codec = StripeCodec(self.code, self.store,
                                     block_size=cfg.block_size,
                                     placement=self.placement,
                                     backend=TorchBackend(cfg.device))
            self.payload = self.rng.integers(
                0, 256, cfg.n_stripes * self.code.k * cfg.block_size,
                dtype=np.uint8).tobytes()
            self.metas = self.codec.write(self.payload)
        else:
            # static block -> node map, mirroring StripeCodec._node_for's
            # slot rotation (cluster, (index-in-cluster + sid) % npc).
            self.node_blocks: dict[int, list[tuple[int, int]]] = {}
            by_cluster = self.placement.blocks_by_cluster()
            for sid in range(cfg.n_stripes):
                for c, members in enumerate(by_cluster):
                    for idx, b in enumerate(members):
                        node = c * self.npc + (idx + sid) % self.npc
                        self.node_blocks.setdefault(node, []).append((sid, b))

        self.scheduler = RepairScheduler(
            self.sim, self.placement, cfg.params,
            block_TB=block_TB,
            stripe_missing=lambda sid: self.missing.get(sid, frozenset()),
            on_repaired=self._on_repaired,
            codec=self.codec,
            topology=cfg.topology,
            max_inflight=cfg.max_inflight_repairs)

        self._node_ev: dict[int, Event] = {}
        for node in range(self.num_nodes):
            self._node_ev[node] = self.sim.schedule_at(
                float(init_lifetimes[node]), self.NODE_FAIL, node=node)
        gap = self.model.next_cluster_loss(self.rng)
        if gap is not None:
            self.sim.schedule(gap, self.CLUSTER_LOSS)

    # -- damage bookkeeping --------------------------------------------------
    def _touch(self) -> None:
        self._degraded_acc += ((self.sim.now - self._last_t)
                               * sum(1 for m in self.missing.values() if m))
        self._last_t = self.sim.now

    def _lost_pairs_of_node(self, node: int) -> list[tuple[int, int]]:
        if self.codec is not None:
            pairs = self.store.blocks_on_node(node)
            # permanent loss of the node's disks; chassis replaced fresh
            self.store.fail_node(node)
            self.store.delete_node_blocks(node)
            self.store.heal_node(node)
            return pairs
        return list(self.node_blocks.get(node, ()))

    def _fail_node(self, node: int, ev: Event | None = None) -> None:
        pairs = self._lost_pairs_of_node(node)
        self._touch()
        fresh = [p for p in pairs
                 if p[1] not in self.missing.get(p[0], set())]
        for sid, b in fresh:
            self.missing.setdefault(sid, set()).add(b)
        # replacement hardware: fresh lifetime, same node id. A cluster
        # loss kills the node out-of-band, so cancel any pending
        # individual failure event — one live NODE_FAIL handle per node.
        stored = self._node_ev.get(node)
        if stored is not None and stored is not ev:
            self.sim.cancel(stored)
        self._node_ev[node] = self.sim.schedule(
            float(self.model.node.sample(self.rng)),
            self.NODE_FAIL, node=node)
        for sid in {sid for sid, _ in fresh}:
            if not self._decodable(sid):
                self.lost_at = self.sim.now
                self.sim.stop()
                return
        if fresh:
            self.scheduler.damaged(fresh)

    def _decodable(self, sid: int) -> bool:
        miss = self.missing.get(sid, set())
        if len(miss) <= self.f:
            return True                 # within distance: always decodable
        try:
            decode_plan_cached(self.code, tuple(miss))
            return True
        except ValueError:
            return False

    # -- event handlers ------------------------------------------------------
    def _on_node_fail(self, sim: Simulator, ev) -> None:
        self._fail_node(ev.payload["node"], ev)

    def _on_cluster_loss(self, sim: Simulator, ev) -> None:
        cluster = self.model.pick_cluster(self.rng, self.num_clusters)
        for slot in range(self.npc):
            if self.lost_at is not None:
                break
            self._fail_node(cluster * self.npc + slot)
        gap = self.model.next_cluster_loss(self.rng)
        if gap is not None and self.lost_at is None:
            self.sim.schedule(gap, self.CLUSTER_LOSS)

    def _on_repaired(self, pairs: list[tuple[int, int]]) -> None:
        self._touch()
        for sid, b in pairs:
            miss = self.missing.get(sid)
            if miss is not None:
                miss.discard(b)
                if not miss:
                    del self.missing[sid]

    # -- driver --------------------------------------------------------------
    def run(self) -> TrialResult:
        end = self.sim.run(until=self.cfg.mission_hours,
                           max_events=self.cfg.max_events_per_trial)
        self._touch()
        observed = self.lost_at if self.lost_at is not None else end
        led = self.scheduler.ledger
        degraded = (self._degraded_acc / (observed * self.cfg.n_stripes)
                    if observed > 0 else 0.0)
        return TrialResult(
            observed_hours=observed,
            lost=self.lost_at is not None,
            loss_hours=self.lost_at,
            degraded_fraction=degraded,
            repaired_blocks=led.repaired_blocks,
            cross_blocks_read=led.cross_blocks_read,
            inner_blocks_read=led.inner_blocks_read,
            kernel_launches=led.kernel_launches,
            repair_jobs=led.jobs)


def run_campaign(cfg: SimConfig) -> CampaignReport:
    """Run cfg.trials independent DssTrials and aggregate.

    MTTDL estimator: total observed time / observed losses (the CR-SIM
    estimator — correct under censoring at mission end); with zero losses
    only the lower bound is meaningful."""
    placement = cfg.resolved_placement()
    model = cfg.resolved_failure_model()
    npc = cfg.resolved_npc()
    num_nodes = placement.num_clusters * npc
    init = _initial_lifetimes(model.node, cfg.seed,
                              (cfg.trials, num_nodes), cfg.device)
    results = [DssTrial(cfg, t, init[t]).run() for t in range(cfg.trials)]

    losses = sum(r.lost for r in results)
    total_h = sum(r.observed_hours for r in results)
    cross = sum(r.cross_blocks_read for r in results)
    inner = sum(r.inner_blocks_read for r in results)
    degraded = (sum(r.degraded_fraction * r.observed_hours
                    for r in results) / total_h) if total_h else 0.0
    return CampaignReport(
        code=cfg.code.name,
        placement=placement.name,
        trials=cfg.trials,
        losses=losses,
        total_hours=total_h,
        mttdl_years=(total_h / losses / HOURS_PER_YEAR) if losses else None,
        mttdl_lower_bound_years=total_h / max(losses, 1) / HOURS_PER_YEAR,
        loss_probability=losses / cfg.trials,
        degraded_fraction=degraded,
        cross_traffic_fraction=(cross / (cross + inner)
                                if cross + inner else 0.0),
        repaired_blocks=sum(r.repaired_blocks for r in results),
        repair_jobs=sum(r.repair_jobs for r in results),
        kernel_launches=sum(r.kernel_launches for r in results))
