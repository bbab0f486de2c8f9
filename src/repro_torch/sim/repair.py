"""Concurrent, risk-aware, bandwidth-constrained repair scheduling over
the topology's links, plan-grouped like the batched recovery engine (the
port's copy of `repro.sim.repair`: every float sum and comparison in the
reference's order, so the ledgers are equal to the reference's).

The scheduler charges each repair job against a `repro_torch.topo.NetworkModel`
built in the Markov chain's units (ε(N-1)B — the exact number behind
μ — as the gateway tier, inner links 1/δ faster, the core carrying
z·pipe/oversubscription). Two charging modes:

  * default (no explicit `topology`): the §5 chain's serialized-pipe
    reading (`NetworkModel.pipe_time`), so a whole-node repair takes
    C·S/bw = 1/μ and multi-failure stripes finish in T (μ' = 1/T) —
    the scheduler and the Markov model agree on units by construction
    (tests/test_mttdl.py pins this). The chain has ONE repair server,
    so this mode is always serial and its job ordering is frozen
    (multi-failure first, then lowest block id) — pipe-mode
    trajectories are bit-identical across scheduler generations.
  * explicit `topology`: per-link bottleneck scheduling
    (`NetworkModel.bottleneck`) *with concurrency*. Jobs are admitted
    against a fluid per-link reservation ledger
    (`repro_torch.topo.LinkReservations`): a job of duration d reserves
    bytes/d on every link it touches and is admitted only if every
    reservation fits the link's residual capacity. Consequences:
    jobs whose bottleneck links are provably disjoint overlap; jobs
    sharing a saturated bottleneck serialize exactly as before; and
    detection-limited multi-failure jobs (duration T > transfer time)
    overlap their detection windows while the shared links stay at —
    never above — capacity. Σ rates ≤ capacity per link is the
    invariant CI gates on (fig_concurrent_repair).

Link-mode queueing is multi-queue and risk-aware (RAFI-style, cf.
CR-SIM's RAFIEventHandler): candidate jobs are ranked by

  1. risk tier — `repro_torch.priority.risk_tier` maps a stripe's live
     erasure count onto the io layer's priority classes (URGENT =
     erasures ≥ f aliases CLIENT_READ, EXPEDITED aliases
     DEGRADED_READ, single-erasure NORMAL aliases BACKGROUND), so the
     scheduler, the front-end, and the ledger speak one enum;
  2. time-to-exposure — fewest further failures until possible data
     loss first;
  3. source-cluster rotation — among equal-risk jobs, round-robin by
     the dominant survivor (uplink) cluster so a correlated cluster
     loss keeps every survivor uplink busy instead of draining
     clusters in placement order;
  4. block id — the deterministic tie-break.

Admission scans ALL candidate groups in that order (skip-ahead: a job
that cannot fit right now does not head-of-line-block a disjoint one
behind it).

Pairs are grouped by recovery plan within a risk tier (same block id
=> same minimal plan, the fast-path invariant
`StripeCodec.recover_blocks` batches on), so a single-failure job is
exactly one batched kernel launch in data-path mode; a multi-failure
job's pairs are further pattern-grouped by the codec engine — one
launch per distinct live erasure pattern.

Cross-cluster byte accounting routes through the network model's
aggregation-validity check: XOR-linear plans ship one pre-folded block
per remote cluster, Cauchy/multi-target plans ship per block.

In data-path mode the scheduler drives real bytes through the request
front-end (`repro_torch.io.RequestFrontend.rebuild`) at the job's risk tier —
URGENT repairs ride the client-read class, routine re-protects stay
BACKGROUND behind any concurrent client reads on the same codec — and
folds the returned kernel-launch delta into its ledger; the launch
counters act as a traffic oracle: launches == plan groups actually
repaired.
"""
from __future__ import annotations

import collections
import dataclasses
from collections.abc import Callable, Set as AbstractSet

from repro_torch.core.codec import decode_plan_cached, plans_for
from repro_torch.core.metrics import (effective_block_traffic,
                                      per_block_repair_traffic)
from repro_torch.core.mttdl import (MTTDLParams, repair_bandwidth_TB_per_hour,
                                    tolerable_failures)
from repro_torch.core.placement import Placement
from repro_torch.priority import Priority, failures_to_exposure, risk_tier
from repro_torch.topo import (LinkReservations, LinkSchedule, NetworkModel,
                              Topology)

from .events import Event, Simulator

REPAIR_DONE = "repair_done"


def node_repair_hours(C_blocks: float, p: MTTDLParams) -> float:
    """Hours to repair one node's worth of data (S TB at effective traffic
    C) through the aggregate pipe — by definition equal to 1/μ."""
    return C_blocks * p.S_TB / repair_bandwidth_TB_per_hour(p)


@dataclasses.dataclass
class RepairLedger:
    """Traffic + launch accounting across one trial."""
    jobs: int = 0
    repaired_blocks: int = 0
    dropped_blocks: int = 0
    inner_blocks_read: int = 0
    cross_blocks_read: int = 0
    busy_hours: float = 0.0
    kernel_launches: int = 0       # data-path mode only
    data_bytes_read: int = 0       # data-path mode only
    plan_groups: int = 0           # batched groups (fast + pattern) executed
    multi_erasure_blocks: int = 0  # blocks healed via pattern decodes
    bottlenecks: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)  # jobs by binding link kind
    jobs_by_class: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)  # jobs by Priority risk tier
    max_concurrent_jobs: int = 0   # high-water mark of in-flight jobs
    peak_link_utilization: float = 0.0  # max over time+links of used/capacity
    max_exposure_hours: float = 0.0  # worst damage -> re-protect window

    @property
    def cross_traffic_fraction(self) -> float:
        total = self.inner_blocks_read + self.cross_blocks_read
        return self.cross_blocks_read / total if total else 0.0


class SchedCore:
    """The scheduler's pure transition semantics, shared with the model
    checker.

    Everything policy-shaped about link/pipe-mode repair — candidate
    grouping and ordering, per-pair link schedules under the live
    erasure pattern, job cost/duration, risk tiering, the round-robin
    cursor advance, traffic accounting — lives here as side-effect-free
    functions of explicit state: the pending pair set, a `missing_of`
    view, the rotation cursor. `RepairScheduler` delegates every
    decision to this core against its live state; the exhaustive
    interleaving explorer (`repro_torch.analysis.model`) evaluates the SAME
    core against abstract states, so the model checker and the
    event-driven scheduler cannot drift apart — there is only one
    implementation of the semantics.
    """

    def __init__(self, placement: Placement, params: MTTDLParams, *,
                 block_TB: float, topology: Topology | None = None):
        self.placement = placement
        self.params = params
        self.block_TB = block_TB
        self.use_links = topology is not None
        self.bw = repair_bandwidth_TB_per_hour(params)
        if topology is None:
            topology = Topology(placement.num_clusters,
                                max(placement.cluster_sizes()))
        self.topology = topology
        self.net = NetworkModel.from_repair_pipe(topology, self.bw,
                                                 params.delta)
        code = placement.code
        self.tolerable = tolerable_failures(code)
        self.traffic = per_block_repair_traffic(code, placement)
        self.eff = effective_block_traffic(code, placement, params.delta)
        plans = plans_for(code)
        # Per-block unit link schedule for the minimal plan (scaled by
        # block_TB · #pairs at job time).
        self.min_sched = [self.net.recovery_schedule(
            placement.assignment, b, plans[b].sources, plan=plans[b])
            for b in range(code.n)]

    MissingOf = Callable[[int], AbstractSet[int]]

    def multi(self, sid: int, missing_of: MissingOf) -> bool:
        return len(missing_of(sid)) >= 2

    def tier(self, sid: int, missing_of: MissingOf) -> Priority:
        return risk_tier(len(missing_of(sid)), self.tolerable)

    def candidate_groups(self, pending, missing_of: MissingOf,
                         rr_cluster: int
                         ) -> list[tuple[tuple, list[tuple[int, int]]]]:
        """Pending pairs bucketed into plan groups, most-urgent first.

        Pipe mode freezes the original serial ordering — (multi-failure?,
        block) — so the Markov-calibrated trajectory is reproduced exactly; the
        chain's μ' state does not distinguish risk tiers. Link mode
        orders by (risk tier, time-to-exposure, rotated dominant source
        cluster, block) and buckets by (tier, block) so one job is one
        priority class end to end."""
        groups: dict[tuple, list[tuple[int, int]]] = {}
        if not self.use_links:
            for (sid, b) in pending:
                rank = 0 if self.multi(sid, missing_of) else 1
                groups.setdefault((rank, b), []).append((sid, b))
            return [(key, groups[key]) for key in sorted(groups)]
        for (sid, b) in pending:
            groups.setdefault((self.tier(sid, missing_of), b),
                              []).append((sid, b))

        def order(item):
            (tier, block), pairs = item
            exposure = min(failures_to_exposure(
                len(missing_of(sid)), self.tolerable)
                for sid, _ in pairs)
            rot = ((self.dominant_cluster(pairs, missing_of) - rr_cluster)
                   % self.topology.num_clusters)
            return (int(tier), exposure, rot, block)
        return sorted(groups.items(), key=order)

    def dominant_cluster(self, group: list[tuple[int, int]],
                         missing_of: MissingOf) -> int:
        """The survivor cluster shipping the most bytes for this group
        (ties to the lowest id); the target's home cluster when nothing
        crosses a gateway. The round-robin interleave cursor rotates
        over this, spreading concurrent jobs across survivor uplinks."""
        uplink: dict[int, float] = {}
        for sid, b in group:
            sched = (self.pair_schedule(sid, b, missing_of)
                     if self.multi(sid, missing_of) else self.min_sched[b])
            for c, bytes_ in sched.uplink.items():
                uplink[c] = uplink.get(c, 0.0) + bytes_
        if uplink:
            return min(uplink, key=lambda c: (-uplink[c], c))
        return int(self.placement.assignment[group[0][1]])

    def next_rr(self, group: list[tuple[int, int]],
                missing_of: MissingOf) -> int:
        """Cursor value after admitting `group` (link mode only)."""
        return ((self.dominant_cluster(group, missing_of) + 1)
                % self.topology.num_clusters)

    def pair_schedule(self, sid: int, b: int,
                      missing_of: MissingOf) -> LinkSchedule:
        """Unit-volume link schedule for repairing (sid, b) under the
        stripe's CURRENT erasure pattern (minimal plan when its sources
        are intact, the real multi-erasure decode plan otherwise)."""
        plan = plans_for(self.placement.code)[b]
        others = set(missing_of(sid)) - {b}
        if others.intersection(plan.sources):
            try:
                dplan = decode_plan_cached(self.placement.code,
                                           tuple(others | {b}))
                return self.net.recovery_schedule(
                    self.placement.assignment, b, dplan.sources, plan=dplan)
            except ValueError:          # beyond tolerance right now
                pass
        return self.min_sched[b]

    def job_cost(self, group: list[tuple[int, int]], missing_of: MissingOf
                 ) -> tuple[float, str, LinkSchedule]:
        """(hours, binding link, merged schedule) for one job run in
        isolation — the duration a fluid reservation divides the job's
        bytes by (`LinkReservations`)."""
        multi = any(self.multi(sid, missing_of) for sid, _ in group)
        if not self.use_links:
            if multi:
                # μ' = 1/T exactly
                return self.params.T_hours, "detection", LinkSchedule()
            # The chain's units, bit for bit: C_b = cross_b + δ·inner_b
            # from the SAME metrics the Markov μ is computed from (the
            # link schedule's inner differs from the chain's C2 under
            # aggregation — gateway-local fold reads vs ARC−CARC — so
            # pipe mode must charge the metrics, not the schedule).
            # δ=0 with zero cross traffic would yield zero-duration jobs
            # and a livelocked event loop when a job re-enqueues its
            # dropped pairs.
            traffic_TB = sum(self.eff[b] for _, b in group) * self.block_TB
            return (max(traffic_TB / self.bw, 1e-9), "pipe",
                    LinkSchedule())
        merged = LinkSchedule()
        for sid, b in group:
            merged.add(self.pair_schedule(sid, b, missing_of) if multi
                       else self.min_sched[b], self.block_TB)
        hours, label = self.net.bottleneck(merged)
        label = label.split("[")[0]        # uplink[3] -> uplink
        if multi and self.params.T_hours >= hours:
            return self.params.T_hours, "detection", merged
        return max(hours, 1e-9), label, merged

    def job_tier(self, group: list[tuple[int, int]],
                 missing_of: MissingOf) -> Priority:
        """The priority class one job rides end to end: the most urgent
        member tier in link mode, the frozen multi/single split in pipe
        mode (the Markov chain's μ' state knows only that much)."""
        if self.use_links:
            return min(self.tier(sid, missing_of) for sid, _ in group)
        return (Priority.URGENT
                if any(self.multi(sid, missing_of) for sid, _ in group)
                else Priority.NORMAL)

    def pair_traffic(self, sid: int, b: int,
                     missing_of: MissingOf) -> tuple[int, int]:
        """(total, cross) blocks read to repair (sid, b) given the stripe's
        CURRENT erasure pattern. Single failure (or plan sources intact):
        the minimal plan. Otherwise the real multi-erasure decode plan —
        whose sources differ, e.g. a UniLRC double-failure inside one
        local group reads global parities from other clusters even under
        the native placement. Cross counts go through the network
        model's aggregation-validity check either way."""
        plan = plans_for(self.placement.code)[b]
        others = set(missing_of(sid)) - {b}
        if not others.intersection(plan.sources):
            return (int(self.traffic[b, 0]), int(self.traffic[b, 1]))
        try:
            dplan = decode_plan_cached(self.placement.code,
                                       tuple(others | {b}))
        except ValueError:                       # beyond tolerance right now
            return (int(self.traffic[b, 0]), int(self.traffic[b, 1]))
        return self.net.recovery_blocks(self.placement.assignment, b,
                                        dplan.sources, plan=dplan)


class RepairScheduler:
    """Per-link, plan-grouped, risk-tiered concurrent repair.

    Wiring: the owner (montecarlo.DssTrial) constructs the scheduler with
    callbacks, calls `damaged(pairs)` as failures land, and receives
    `on_repaired(pairs)` when a job completes. The scheduler registers
    its own REPAIR_DONE handler on the simulator. Passing an explicit
    `topology` switches from the Markov-calibrated pipe to per-link
    bottleneck charging with concurrent admission (see module
    docstring); `max_inflight=1` there recovers the serialized
    baseline the concurrency benchmarks compare against.

    All policy decisions route through a `SchedCore` — the pure
    transition functions the model checker (`repro_torch.analysis.schedcheck`)
    exhaustively explores. `observer`, if given, receives
    `admitted(group, tier, hours, bottleneck, rates)` /
    `completed(group)` callbacks in event order (the differential
    harness records these to prove model/simulator step agreement).
    `unsafe_admission=True` re-introduces the oversubscribing admission
    bug the model checker exists to rule out — test-only, never set it.
    """

    def __init__(self, sim: Simulator, placement: Placement,
                 params: MTTDLParams, *,
                 block_TB: float,
                 stripe_missing: Callable[[int], AbstractSet[int]],
                 on_repaired: Callable[[list[tuple[int, int]]], None],
                 codec=None,
                 topology: Topology | None = None,
                 max_inflight: int | None = None,
                 exclude_node_of: Callable[[int, int], int] | None = None,
                 observer=None,
                 unsafe_admission: bool = False):
        self.sim = sim
        self.placement = placement
        self.params = params
        self.block_TB = block_TB
        # currently-missing blocks of a stripe (including ones queued or in
        # flight here) — drives both risk-tier prioritisation and the
        # actual-plan traffic accounting.
        self.stripe_missing = stripe_missing
        self.on_repaired = on_repaired
        self.codec = codec                      # StripeCodec for data-path
        self.frontend = None
        if codec is not None:
            from repro_torch.io import RequestFrontend
            self.frontend = RequestFrontend(codec)
        self.exclude_node_of = exclude_node_of
        self.observer = observer
        self.ledger = RepairLedger()
        self._use_links = topology is not None
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if not self._use_links and max_inflight not in (None, 1):
            # The Markov chain models ONE repair server; overlapping
            # pipe-mode jobs would silently break the μ calibration.
            raise ValueError("concurrent repair (max_inflight > 1) "
                             "requires an explicit topology")
        self.max_inflight = (1 if not self._use_links else max_inflight)
        self.core = SchedCore(placement, params, block_TB=block_TB,
                              topology=topology)
        self.topology = self.core.topology
        self.net = self.core.net
        self.reservations = LinkReservations(
            self.net, unsafe_ignore_residual=unsafe_admission)
        self._pending: dict[tuple[int, int], None] = {}   # ordered set
        self._damaged_at: dict[tuple[int, int], float] = {}
        # In-flight jobs: event seq -> per-link rates reserved for it
        # (Event itself is an eq-comparable dataclass, not hashable).
        self._active: dict[int, dict[tuple, float]] = {}
        self._rr_cluster = 0       # source-cluster round-robin cursor
        sim.on(REPAIR_DONE, self._handle_done)

    # -- damage intake -------------------------------------------------------
    def damaged(self, pairs: list[tuple[int, int]]) -> None:
        for p in pairs:
            self._pending.setdefault(p, None)
            # first-damage timestamp survives requeues: the window of
            # vulnerability runs until the block is actually re-placed.
            self._damaged_at.setdefault(p, self.sim.now)
        self._kick()

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def in_flight(self) -> int:
        return len(self._active)

    def _multi(self, sid: int) -> bool:
        return self.core.multi(sid, self.stripe_missing)

    def _tier(self, sid: int) -> Priority:
        return self.core.tier(sid, self.stripe_missing)

    # -- scheduling ----------------------------------------------------------
    def _candidate_groups(self) -> list[tuple[tuple, list[tuple[int, int]]]]:
        return self.core.candidate_groups(self._pending, self.stripe_missing,
                                          self._rr_cluster)

    def _pair_traffic(self, sid: int, b: int) -> tuple[int, int]:
        return self.core.pair_traffic(sid, b, self.stripe_missing)

    def _admit(self, key: tuple, group: list[tuple[int, int]]) -> bool:
        """Try to start one group; True if it was put in flight."""
        hours, bottleneck, merged = self.core.job_cost(group,
                                                       self.stripe_missing)
        rates: dict[tuple, float] = {}
        if self._use_links:
            rates = self.reservations.rates_for(merged, hours)
            if not self.reservations.admits(rates):
                self.reservations.rejected += 1
                return False
            self.reservations.reserve(rates)
            self._rr_cluster = self.core.next_rr(group, self.stripe_missing)
        tier = self.core.job_tier(group, self.stripe_missing)
        for p in group:
            del self._pending[p]
        ev = self.sim.schedule(hours, REPAIR_DONE,
                               pairs=group, hours=hours,
                               bottleneck=bottleneck, tier=tier)
        self._active[ev.seq] = rates
        self.ledger.max_concurrent_jobs = max(self.ledger.max_concurrent_jobs,
                                              len(self._active))
        if self.observer is not None:
            self.observer.admitted(list(group), tier, hours, bottleneck,
                                   dict(rates))
        return True

    def _kick(self) -> None:
        """Admit as many pending groups as capacity allows. Serial modes
        (pipe, or max_inflight=1) admit only the single best group when
        idle — the original serial behavior. Concurrent link mode scans the
        whole risk-ordered candidate list each pass (skip-ahead: a job that
        does not fit cannot block a disjoint one behind it) and repeats
        until a full scan admits nothing."""
        while self._pending:
            if (self.max_inflight is not None
                    and len(self._active) >= self.max_inflight):
                return
            admitted = False
            for key, group in self._candidate_groups():
                if self._admit(key, group):
                    admitted = True
                    break              # recompute candidates: state moved
                if not self._use_links or self.max_inflight == 1:
                    return             # serial: only the best group may run
            if not admitted:
                return                 # nothing fits until a job completes

    # -- completion ----------------------------------------------------------
    def _handle_done(self, sim: Simulator, ev: Event) -> None:
        group: list[tuple[int, int]] = ev.payload["pairs"]
        tier: Priority = ev.payload["tier"]
        rates = self._active.pop(ev.seq)
        if self.observer is not None:
            self.observer.completed(list(group))
        if self._use_links:
            self.reservations.release(rates)
            self.ledger.peak_link_utilization = max(
                self.ledger.peak_link_utilization,
                self.reservations.peak_utilization)
        self.ledger.jobs += 1
        self.ledger.jobs_by_class[tier] += 1
        self.ledger.busy_hours += ev.payload["hours"]
        self.ledger.bottlenecks[ev.payload["bottleneck"]] += 1
        placed = group
        if self.codec is not None:
            exclude = (self.exclude_node_of(*group[0])
                       if self.exclude_node_of else -1)
            report = self.frontend.rebuild(group, exclude_node=exclude,
                                           priority=tier)
            self.ledger.kernel_launches += report.launches
            self.ledger.data_bytes_read += (report.inner_bytes
                                            + report.cross_bytes)
            self.ledger.plan_groups += report.plan_groups
            self.ledger.multi_erasure_blocks += report.multi_pairs
            if report.placed < report.requested:
                # unrecoverable right now (overlapping failure landed while
                # this job was in flight) — the owner decides whether the
                # stripe is lost; recoverable leftovers re-enter the queue.
                placed = [p for p in group if self.codec.store.available(*p)]
        for sid, b in placed:
            total, cross = self._pair_traffic(sid, b)
            self.ledger.repaired_blocks += 1
            self.ledger.inner_blocks_read += total - cross
            self.ledger.cross_blocks_read += cross
            born = self._damaged_at.pop((sid, b), sim.now)
            self.ledger.max_exposure_hours = max(
                self.ledger.max_exposure_hours, sim.now - born)
        dropped = [p for p in group if p not in set(placed)]
        self.ledger.dropped_blocks += len(dropped)
        self.on_repaired(placed)
        # transiently unrecoverable pairs go back in the queue; each job
        # costs positive time, so retries cannot livelock the clock.
        if dropped:
            self.damaged(dropped)
        else:
            self._kick()
