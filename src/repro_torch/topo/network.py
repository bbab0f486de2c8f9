"""NetworkModel: plans + placements -> per-link transfer schedules
(port of `repro.topo.network`, all of it).

Two questions every consumer keeps re-answering, answered once:

  1. *How many blocks cross a gateway* for a recovery — including the
     paper's §3.3 gateway-aggregation reading, where each remote
     cluster pre-folds its XOR-linear contribution and ships ONE block
     (so the relaxed "one group, t clusters" placement costs t−1 cross
     blocks, not |remote sources|). Aggregation is validity-checked:
     a plain-XOR gateway cannot fold Cauchy-coefficient plans or
     multi-target decodes (`plan_is_xor_linear`).
  2. *How long the transfer takes* given the link tiers — per-cluster
     gateway uplinks/downlinks, the oversubscribed core, and intra-
     cluster NICs — as a bottleneck (max-over-links) time, or as the
     Markov-calibrated serialized pipe the §5 chain assumes
     (`pipe_time` reproduces ε(N−1)B accounting exactly, so the
     closed-form MTTDL and a simulator keep agreeing on units).

Plus the fluid-flow reservation arithmetic (`flow_rates`,
`reservation_fits`, `merge_reservation`, `release_reservation`) and the
`LinkReservations` ledger built on it. Numpy only.

Plans are duck-typed (`.sources` + `.coeffs`/`.xor_only` for a
RecoveryPlan, `.erased` + `.M` for a DecodePlan) so this module sits
*below* `repro_torch.core` with no import cycle.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .topology import Topology


def plan_is_xor_linear(plan) -> bool:
    """True when a plain-XOR gateway can pre-fold the plan's remote
    contribution: every GF coefficient is 1 and the plan produces a
    single output block. RecoveryPlans expose `.xor_only`; DecodePlans
    qualify only with one erased target and a 0/1 coefficient row
    (a multi-target decode needs per-target GF rows at the gateway,
    which the aggregation story does not assume)."""
    coeffs = getattr(plan, "coeffs", None)
    if coeffs is not None:                          # RecoveryPlan
        return all(c == 1 for c in coeffs)
    M = getattr(plan, "M", None)
    if M is not None:                               # DecodePlan
        return (len(plan.erased) == 1
                and bool(np.all((np.asarray(M) == 0) | (np.asarray(M) == 1))))
    return False


def cross_cluster_blocks(assignment, target: int, sources, *,
                         aggregate: bool = False) -> int:
    """# block transfers crossing a gateway to repair `target`.

    aggregate=False: every remote source block ships individually.
    aggregate=True: each remote cluster ships ONE pre-folded block —
    the caller is responsible for having checked `plan_is_xor_linear`.
    """
    home = assignment[target]
    remote = [assignment[s] for s in sources if assignment[s] != home]
    return len(set(remote)) if aggregate else len(remote)


@dataclasses.dataclass
class LinkSchedule:
    """Per-link byte totals for one (or many merged) transfers.

    All cross-cluster bytes appear exactly once in `uplink` (leaving
    the source cluster's gateway), once on the core, and once in
    `down` (entering the consumer's cluster); `inner` holds bytes that
    never leave their cluster — both target-local reads and the
    gateway-local reads behind a pre-fold."""
    inner: dict[int, float] = dataclasses.field(default_factory=dict)
    uplink: dict[int, float] = dataclasses.field(default_factory=dict)
    down: dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def inner_bytes(self) -> float:
        return sum(self.inner.values())

    @property
    def cross_bytes(self) -> float:
        return sum(self.uplink.values())

    def add(self, other: "LinkSchedule", scale: float = 1.0) -> None:
        for mine, theirs in ((self.inner, other.inner),
                             (self.uplink, other.uplink),
                             (self.down, other.down)):
            for c, b in theirs.items():
                mine[c] = mine.get(c, 0.0) + b * scale

    def scaled(self, factor: float) -> "LinkSchedule":
        out = LinkSchedule()
        out.add(self, factor)
        return out


class NetworkModel:
    """Bandwidth-annotated view of a `Topology`.

    Bandwidths are in *bytes (or TB, or blocks) per time unit* — any
    consistent unit: the benchmarks build one in bytes/second from the
    topology's Gb/s links, the failure simulator in TB/hour from the
    Markov chain's ε(N−1)B pipe (`from_repair_pipe`)."""

    def __init__(self, topo: Topology, *, cross_bw: float,
                 inner_bw: float, core_bw: float | None = None):
        if cross_bw <= 0 or inner_bw <= 0:
            raise ValueError("link bandwidths must be positive")
        self.topo = topo
        self.cross_bw = float(cross_bw)
        self.inner_bw = float(inner_bw)
        self.core_bw = float(core_bw) if core_bw is not None else (
            topo.num_clusters * self.cross_bw / topo.oversubscription)

    @classmethod
    def from_topology(cls, topo: Topology) -> "NetworkModel":
        """Bytes/second from the topology's per-tier Gb/s links."""
        to_Bps = 1e9 / 8
        return cls(topo, cross_bw=topo.cross_gbps * to_Bps,
                   inner_bw=topo.inner_gbps * to_Bps,
                   core_bw=topo.core_gbps * to_Bps)

    @classmethod
    def from_repair_pipe(cls, topo: Topology, pipe_bw: float,
                         delta: float) -> "NetworkModel":
        """Markov-chain units: the §5 aggregate repair pipe ε(N−1)B
        becomes the gateway tier, inner links run 1/δ faster (δ is the
        chain's cross/inner bandwidth ratio; δ=0 means inner reads are
        free, matching C = C1 + δ·C2), and the core carries
        z·pipe/oversubscription."""
        inner = pipe_bw / delta if delta > 0 else math.inf
        return cls(topo, cross_bw=pipe_bw, inner_bw=inner,
                   core_bw=(topo.num_clusters * pipe_bw
                            / topo.oversubscription))

    # -- plan -> schedule ----------------------------------------------------
    def recovery_schedule(self, assignment, target: int, sources, *,
                          plan=None, block_bytes: float = 1.0
                          ) -> LinkSchedule:
        """Per-link bytes to rebuild `target` (consumed in its home
        cluster) from `sources`. When `plan` is XOR-linear, each remote
        cluster pre-folds its members at the gateway (their reads stay
        intra-cluster) and ships ONE block."""
        aggregate = plan is not None and plan_is_xor_linear(plan)
        home = assignment[target]
        sched = LinkSchedule()
        by_cluster: dict[int, int] = {}
        for s in sources:
            c = assignment[s]
            by_cluster[c] = by_cluster.get(c, 0) + 1
        for c, count in by_cluster.items():
            if c == home:
                sched.inner[c] = sched.inner.get(c, 0.0) + count * block_bytes
            elif aggregate and count > 1:
                sched.inner[c] = sched.inner.get(c, 0.0) + count * block_bytes
                sched.uplink[c] = sched.uplink.get(c, 0.0) + block_bytes
                sched.down[home] = sched.down.get(home, 0.0) + block_bytes
            else:
                sched.uplink[c] = (sched.uplink.get(c, 0.0)
                                   + count * block_bytes)
                sched.down[home] = (sched.down.get(home, 0.0)
                                    + count * block_bytes)
        return sched

    def recovery_blocks(self, assignment, target: int, sources, *,
                        plan=None) -> tuple[int, int]:
        """(total blocks read, cross-cluster block transfers) with the
        aggregation-validity check applied — the per-block numbers
        behind ARC/CARC and the repair ledger."""
        aggregate = plan is not None and plan_is_xor_linear(plan)
        sources = list(sources)
        return (len(sources),
                cross_cluster_blocks(assignment, target, sources,
                                     aggregate=aggregate))

    # -- schedule -> time ----------------------------------------------------
    def pipe_time(self, sched: LinkSchedule) -> float:
        """The §5 chain's serialized-pipe reading of a schedule: cross
        bytes through the ε(N−1)B gateway tier plus inner bytes at 1/δ.
        Note the chain's own C2 is ARC−CARC, which under gateway
        aggregation differs from a schedule's inner bytes (fold inputs
        read at a remote gateway count as inner here) — charging the
        exact Markov units is the caller's job via the metrics
        (the reference's `sim.RepairScheduler` does exactly that in
        pipe mode)."""
        return (sched.cross_bytes / self.cross_bw
                + sched.inner_bytes / self.inner_bw)

    def bottleneck(self, sched: LinkSchedule) -> tuple[float, str]:
        """(transfer time, binding link) under the per-link model: every
        tier moves in parallel and the slowest link gates the transfer.
        Terms: per-cluster intra reads + shipped-block ingest on node
        NICs, per-cluster gateway uplinks/downlinks, and the shared
        (oversubscribed) core."""
        best, label = 0.0, "idle"
        for c in set(sched.inner) | set(sched.down):
            t = (sched.inner.get(c, 0.0)
                 + sched.down.get(c, 0.0)) / self.inner_bw
            if t > best:
                best, label = t, f"ingest[{c}]"
        for c, b in sched.uplink.items():
            if b / self.cross_bw > best:
                best, label = b / self.cross_bw, f"uplink[{c}]"
        for c, b in sched.down.items():
            if b / self.cross_bw > best:
                best, label = b / self.cross_bw, f"downlink[{c}]"
        core = sched.cross_bytes / self.core_bw
        if core > best:
            best, label = core, "core"
        return best, label

    def transfer_time(self, sched: LinkSchedule) -> float:
        return self.bottleneck(sched)[0]

    # -- concurrent admission ------------------------------------------------
    def link_loads(self, sched: LinkSchedule) -> dict[tuple, float]:
        """Flatten a schedule to {link key: bytes} over the SAME link
        terms `bottleneck()` maxes over, keyed ("ingest", c) /
        ("uplink", c) / ("downlink", c) / ("core",). Invariant (pinned
        by tests): bottleneck(sched)[0] ==
        max(load / self.link_capacity(key)) over these entries — the
        flattening and the serial cost model can never disagree about
        which links a job occupies."""
        loads: dict[tuple, float] = {}
        for c in set(sched.inner) | set(sched.down):
            b = sched.inner.get(c, 0.0) + sched.down.get(c, 0.0)
            if b > 0:
                loads[("ingest", c)] = b
        for c, b in sched.uplink.items():
            if b > 0:
                loads[("uplink", c)] = b
        for c, b in sched.down.items():
            if b > 0:
                loads[("downlink", c)] = b
        cross = sched.cross_bytes
        if cross > 0:
            loads[("core",)] = cross
        return loads

    def link_capacity(self, key: tuple) -> float:
        """Bandwidth of one flattened link key (same units as the model)."""
        kind = key[0]
        if kind == "ingest":
            return self.inner_bw
        if kind in ("uplink", "downlink"):
            return self.cross_bw
        if kind == "core":
            return self.core_bw
        raise KeyError(f"unknown link key {key!r}")


#: Relative admission tolerance shared by the live ledger and the model
#: checker: a job may fill a link to exactly its capacity; the epsilon
#: only absorbs float rounding from the bytes/duration division, never
#: real oversubscription.
RESERVATION_EPS = 1e-9


def flow_rates(net: NetworkModel, sched: LinkSchedule,
               duration: float) -> dict[tuple, float]:
    """Pure reservation arithmetic: a job of `duration` moving `sched`'s
    bytes is a constant-rate flow of bytes/duration on every link it
    touches. This is THE rate computation — `LinkReservations` and the
    reference's scheduler model checker both call it, so
    the admission semantics cannot fork."""
    if duration <= 0:
        raise ValueError("transfer duration must be positive")
    return {key: b / duration
            for key, b in net.link_loads(sched).items()}


def reservation_fits(used, rates, capacity_of, *,
                     eps: float = RESERVATION_EPS,
                     ignore_residual: bool = False) -> bool:
    """Pure admission predicate: do `rates` fit the residual capacity on
    every link, given the per-link `used` totals? Number-generic on
    purpose: the live ledger passes floats, the model checker passes
    exact `fractions.Fraction` sums (Python compares them exactly).

    `ignore_residual=True` is the deliberately BROKEN variant behind the
    model checker's counterexample tests: it checks each job in
    isolation (rate <= capacity) and ignores what is already reserved —
    the classic oversubscription bug. Never enable it outside a test.
    """
    for key, r in rates.items():
        cap = capacity_of(key)
        base = 0 if ignore_residual else used.get(key, 0)
        if base + r > cap * (1.0 + eps):
            return False
    return True


def merge_reservation(used, rates):
    """Pure reserve: a new {link: total} map with `rates` added."""
    new = dict(used)
    for key, r in rates.items():
        new[key] = new.get(key, 0) + r
    return new


def release_reservation(used, rates, capacity_of, *,
                        eps: float = RESERVATION_EPS):
    """Pure release: a new map with `rates` subtracted and float dust
    (anything at or below eps * capacity) clamped back to idle."""
    new = dict(used)
    for key, r in rates.items():
        left = new.get(key, 0) - r
        if left <= eps * capacity_of(key):
            new.pop(key, None)
        else:
            new[key] = left
    return new


class LinkReservations:
    """Fluid-flow residual-capacity ledger for concurrent transfers.

    Each admitted job runs for a fixed duration d (its *exclusive*
    bottleneck time, possibly stretched by a detection floor) and is
    modelled as a constant-rate flow: on every link it touches it
    reserves rate = bytes_on_link / d. A job is admitted only if every
    such rate fits in the link's residual capacity, so

        sum over in-flight jobs of rate(link)  <=  capacity(link)

    holds at all times — the oversubscription invariant CI gates on.
    Consequences that make this the right model for repair overlap:

      * a job whose duration IS its bottleneck transfer time reserves
        that link at full capacity — two jobs sharing a bottleneck link
        serialize, exactly like the old one-at-a-time scheduler;
      * jobs with provably disjoint link sets overlap freely;
      * a detection-limited job (duration T > transfer time) reserves
        only bytes/T on each link, so ~T/transfer such jobs overlap
        while their shared links stay at (not above) capacity.

    Release must be exact under float arithmetic, so `reserve` returns
    the rate dict and `release` subtracts those same floats (with a
    drop-to-zero clamp against residual dust).
    """

    #: Relative tolerance for admission — see `RESERVATION_EPS`.
    EPS = RESERVATION_EPS

    def __init__(self, net: NetworkModel, *,
                 unsafe_ignore_residual: bool = False):
        self.net = net
        self._used: dict[tuple, float] = {}
        self.peak_utilization = 0.0   # max over time+links of used/capacity
        self.admitted = 0
        self.rejected = 0             # admission attempts that had to wait
        # TEST-ONLY: the oversubscribing admission variant the model
        # checker's counterexample harness re-introduces on purpose.
        self.unsafe_ignore_residual = unsafe_ignore_residual

    def rates_for(self, sched: LinkSchedule,
                  duration: float) -> dict[tuple, float]:
        return flow_rates(self.net, sched, duration)

    def admits(self, rates: dict[tuple, float]) -> bool:
        """Would these per-link rates fit in the residual capacity?"""
        return reservation_fits(
            self._used, rates, self.net.link_capacity, eps=self.EPS,
            ignore_residual=self.unsafe_ignore_residual)

    def reserve(self, rates: dict[tuple, float]) -> None:
        """Commit the rates (caller already checked `admits`)."""
        self._used = merge_reservation(self._used, rates)
        for key in rates:
            cap = self.net.link_capacity(key)
            used = self._used.get(key, 0.0)
            if cap > 0 and used / cap > self.peak_utilization:
                self.peak_utilization = used / cap
        self.admitted += 1

    def release(self, rates: dict[tuple, float]) -> None:
        """Return a completed job's rates — the exact floats reserved."""
        self._used = release_reservation(self._used, rates,
                                         self.net.link_capacity,
                                         eps=self.EPS)

    def utilization(self, key: tuple) -> float:
        cap = self.net.link_capacity(key)
        return self._used.get(key, 0.0) / cap if cap > 0 else 0.0

    @property
    def busy_links(self) -> int:
        return len(self._used)
