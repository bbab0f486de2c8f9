"""Explicit-state model of the concurrent repair scheduler (the port's
copy of `repro.analysis.model`, over the port's `SchedCore`).

`sim.RepairScheduler` is an event-driven program whose correctness
claims — never-oversubscribed links, no deadlock, no starvation,
bounded priority inversion, frozen pipe-mode ordering — are quantified
over *every* interleaving of damage arrivals and job completions. The
benchmarks and property tests only sample trajectories; this module
proves the claims for bounded scenarios by exhaustive exploration.

The construction deliberately avoids the classic model-vs-code drift
problem: the scheduler's whole policy lives in `sim.repair.SchedCore`
as pure functions of explicit state (pending pairs, a `missing_of`
view, the rotation cursor), and this checker evaluates the SAME core
against abstract states. There is one implementation of the semantics;
the model cannot disagree with the simulator about what an admission
decides, only about *when* events fire — which is exactly the
dimension being exhausted.

Abstract state
--------------
    State = (pending pairs in arrival order,
             frozenset of in-flight Jobs,
             #batches delivered, round-robin cursor)

A `Job` carries the sorted pair group, tier, duration, bottleneck
label and the exact per-link float rates the live ledger would have
reserved. Link residuals are *derived* (summing in-flight rates), not
stored, so states canonicalize for free. Two transition kinds:

  * ``deliver``  — the next damage batch lands, then the admission
    loop (`_kick`, a faithful transplant of the scheduler's) runs to
    its fixed point;
  * ``complete`` — one in-flight job finishes, releases its rates,
    then the admission loop runs.

Every transition strictly increases (delivered, repaired pairs), so
the reachable graph is a finite DAG: BFS terminates and every maximal
path ends in a terminal state — which is how starvation-freedom
reduces to a terminal-state check.

Partial-order reduction
-----------------------
Visited-state dedup already collapses most commuting interleavings.
On top of that, a *drain collapse* rule fires when (a) all batches
have been delivered, (b) no pending stripe shares a stripe id with
any in-flight job, and (c) releasing ALL in-flight jobs at once
admits nothing new. Then every ordering of the remaining completions
visits states with strictly smaller link usage and an unchanged
pending queue, so all k! orderings are equivalent to one joint
``drain`` step. Soundness rests on admission being monotone in free
capacity (`reservation_fits` is per-link comparison against a fixed
capacity): if nothing fits with every link idle, nothing fits with
less. Condition (b) pins `missing_of` — and hence tiers, plans and
job costs — across the collapsed region. The checker counts the
orderings it pruned, and the test-suite re-explores with ``por=False``
to confirm verdict and terminal-state equivalence.

Checked properties (the six certificate claims)
-----------------------------------------------
  * ``link_safety`` — in every reachable state, the per-link sum of
    in-flight rates is <= capacity * (1 + RESERVATION_EPS). Summation
    uses exact `fractions.Fraction` arithmetic (floats embed exactly),
    so no accumulation order can hide an overflow.
  * ``deadlock_freedom`` — no terminal state has pending work.
  * ``work_conservation`` — every reachable state is an admission
    fixed point: no candidate the scheduler's scan would admit is
    left waiting (serial modes scan only the head, mirroring the
    code's intentional head-of-line rule).
  * ``starvation_freedom`` — every terminal state is fully repaired;
    with the DAG measure this means every run terminates with every
    pair (NORMAL tier included) repaired.
  * ``bounded_priority_inversion`` — at the moment any group is
    admitted, every strictly-higher-tier pending group did not fit
    the pre-admission residuals: an urgent job waits only on the
    in-flight residue, never on a later-queued lower tier taking a
    slot it could have used. The maximum number of lower-tier
    in-flight jobs observed while an URGENT group was pending is
    reported as the inversion width.
  * ``pipe_determinism`` — pipe-mode scenarios reach every state with
    out-degree <= 1 and admit only the head of the frozen
    (multi-failure?, block) order: the single serialized trace the
    Markov calibration assumes.

Violations carry the BFS-minimal event trace from the initial state,
which `repro_torch.analysis.schedcheck` replays through the real
`Simulator`.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from collections.abc import Iterator, Set as AbstractSet
from fractions import Fraction
from typing import Any

from repro_torch.priority import Priority
from repro_torch.topo.network import (RESERVATION_EPS, flow_rates,
                                      merge_reservation, reservation_fits)

Pair = tuple[int, int]
LinkKey = tuple  # ("ingest", c) | ("uplink", c) | ("downlink", c) | ("core",)

PROPERTIES = ("link_safety", "deadlock_freedom", "work_conservation",
              "starvation_freedom", "bounded_priority_inversion",
              "pipe_determinism")


@dataclasses.dataclass(frozen=True)
class Job:
    """One in-flight repair job, exactly as the scheduler would run it."""
    pairs: tuple[Pair, ...]                      # sorted
    tier: int
    hours: float
    bottleneck: str
    rates: tuple[tuple[LinkKey, float], ...]     # sorted by link key


@dataclasses.dataclass(frozen=True)
class State:
    """Canonical post-kick scheduler state. Link residuals are derived
    from `inflight`, and the repaired set from what is absent, so equal
    states hash equal without bookkeeping."""
    pending: tuple[Pair, ...]        # arrival order (pairs never re-enter)
    inflight: frozenset[Job]
    delivered: int                   # batches landed so far
    rr: int                          # source-cluster round-robin cursor

    def repaired_count(self, total_pairs: int) -> int:
        gone = len(self.pending) + sum(len(j.pairs) for j in self.inflight)
        return total_pairs - gone


@dataclasses.dataclass(frozen=True)
class Admission:
    """One admission the kick loop performed (deterministic per step)."""
    pairs: tuple[Pair, ...]
    tier: int
    hours: float
    bottleneck: str
    rates: tuple[tuple[LinkKey, float], ...]
    cand_index: int                  # position in the candidate scan


@dataclasses.dataclass(frozen=True)
class Step:
    """One transition: the nondeterministic event plus the deterministic
    admissions the post-event kick performed."""
    event: tuple[Any, ...]           # ("deliver", i) | ("complete", pairs)
                                     # | ("drain",)
    admissions: tuple[Admission, ...]


@dataclasses.dataclass(frozen=True)
class Violation:
    prop: str
    detail: str
    trace: tuple[Step, ...]          # BFS-minimal path from the start

    def to_dict(self) -> dict[str, Any]:
        return {"property": self.prop, "detail": self.detail,
                "trace": [{"event": list(s.event),
                           "admissions": [list(a.pairs)
                                          for a in s.admissions]}
                          for s in self.trace]}


@dataclasses.dataclass
class ExploreResult:
    """Everything one exhaustive exploration established."""
    states: int = 0
    transitions: int = 0
    terminals: int = 0
    pruned_orderings: int = 0        # completion orderings drain-collapsed
    max_inflight_seen: int = 0
    inversion_width: int = 0
    admissions: int = 0
    exhaustive: bool = True          # False iff max_states tripped
    properties: dict[str, bool] = dataclasses.field(default_factory=dict)
    violations: list[Violation] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (self.exhaustive and not self.violations
                and all(self.properties.values()))

    def first_violation(self, prop: str) -> Violation | None:
        for v in self.violations:
            if v.prop == prop:
                return v
        return None


class SchedModel:
    """Small-step transition system over `SchedCore` + explorer.

    `core` is a `sim.repair.SchedCore`; `batches` the damage arrivals
    (each a sequence of (stripe, block) pairs, no pair repeated across
    the scenario); `max_inflight`/`unsafe` mirror the scheduler
    constructor knobs. `pipe_expected=True` additionally checks the
    frozen-trace determinism certificate (set it for pipe scenarios)."""

    def __init__(self, core: Any, batches: Any, *,
                 max_inflight: int | None = None,
                 unsafe: bool = False,
                 por: bool = True,
                 pipe_expected: bool = False,
                 max_states: int = 200_000) -> None:
        self.core = core
        self.use_links = bool(core.use_links)
        self.batches: tuple[tuple[Pair, ...], ...] = tuple(
            tuple((int(s), int(b)) for s, b in batch) for batch in batches)
        flat = [p for batch in self.batches for p in batch]
        if len(set(flat)) != len(flat):
            raise ValueError("a (stripe, block) pair may appear in only "
                             "one batch of a scenario")
        self.total_pairs = len(flat)
        # Mirror RepairScheduler.__init__: pipe mode is always serial.
        self.max_inflight = 1 if not self.use_links else max_inflight
        self.unsafe = unsafe
        self.por = por
        self.pipe_expected = pipe_expected
        self.max_states = max_states
        self._pruned = 0
        self._kick_inversions: dict[Step, list[Violation]] = {}

    # -- shared state arithmetic --------------------------------------------
    def _missing_map(self, pending: Any,
                     inflight: Any) -> dict[int, frozenset[int]]:
        raw: dict[int, set[int]] = {}
        for sid, b in pending:
            raw.setdefault(sid, set()).add(b)
        for job in inflight:
            for sid, b in job.pairs:
                raw.setdefault(sid, set()).add(b)
        return {sid: frozenset(bs) for sid, bs in raw.items()}

    def _used(self, inflight: Any) -> dict[LinkKey, float]:
        """Float link residual ledger, rebuilt in canonical job order —
        the policy-side view (the safety *property* re-sums exactly)."""
        used: dict[LinkKey, float] = {}
        for job in sorted(inflight, key=lambda j: j.pairs):
            used = merge_reservation(used, dict(job.rates))
        return used

    # -- the admission loop (transplanted RepairScheduler._kick) ------------
    def _kick(self, pending: Any, inflight: Any, rr: int,
              ) -> tuple[tuple[Pair, ...], frozenset[Job], int,
                         tuple[Admission, ...], list[Violation]]:
        """Run admissions to their fixed point. Returns the post-kick
        state pieces, the admissions performed, and any priority-
        inversion violations observed *at admission time*."""
        pend: list[Pair] = list(pending)
        jobs: set[Job] = set(inflight)
        used = self._used(jobs)
        admissions: list[Admission] = []
        inversions: list[Violation] = []
        cap_of = self.core.net.link_capacity
        while pend:
            if (self.max_inflight is not None
                    and len(jobs) >= self.max_inflight):
                break
            missing = self._missing_map(pend, jobs)

            def missing_of(sid: int,
                           _m: dict[int, frozenset[int]] = missing
                           ) -> AbstractSet[int]:
                return _m.get(sid, frozenset())

            cands = self.core.candidate_groups(pend, missing_of, rr)
            admitted = False
            serial_stop = False
            for idx, (_key, group) in enumerate(cands):
                hours, label, merged = self.core.job_cost(group, missing_of)
                rates: dict[LinkKey, float] = {}
                fits = True
                if self.use_links:
                    rates = flow_rates(self.core.net, merged, hours)
                    fits = reservation_fits(used, rates, cap_of,
                                            ignore_residual=self.unsafe)
                if not fits:
                    if not self.use_links or self.max_inflight == 1:
                        serial_stop = True     # serial: head-of-line only
                        break
                    continue                   # skip-ahead
                tier = int(self.core.job_tier(group, missing_of))
                # Priority-inversion audit: every candidate scanned past
                # (strictly higher tier) must genuinely not fit.
                for _pk, pgroup in cands[:idx]:
                    ptier = int(self.core.job_tier(pgroup, missing_of))
                    if ptier >= tier:
                        continue
                    ph, _pl, pm = self.core.job_cost(pgroup, missing_of)
                    pr = (flow_rates(self.core.net, pm, ph)
                          if self.use_links else {})
                    if reservation_fits(used, pr, cap_of,
                                        ignore_residual=self.unsafe):
                        inversions.append(Violation(
                            "bounded_priority_inversion",
                            f"admitted tier-{tier} group {sorted(group)} "
                            f"while admissible tier-{ptier} group "
                            f"{sorted(pgroup)} waited", ()))
                used = merge_reservation(used, rates)
                if self.use_links:
                    rr = int(self.core.next_rr(group, missing_of))
                for p in group:
                    pend.remove(p)
                job = Job(pairs=tuple(sorted(group)), tier=tier,
                          hours=float(hours), bottleneck=str(label),
                          rates=tuple(sorted(rates.items())))
                jobs.add(job)
                admissions.append(Admission(
                    pairs=job.pairs, tier=tier, hours=job.hours,
                    bottleneck=job.bottleneck, rates=job.rates,
                    cand_index=idx))
                admitted = True
                break                          # recompute candidates
            if serial_stop or not admitted:
                break
        return (tuple(pend), frozenset(jobs), rr,
                tuple(admissions), inversions)

    # -- transitions ---------------------------------------------------------
    def initial(self) -> State:
        return State(pending=(), inflight=frozenset(), delivered=0, rr=0)

    def _can_drain(self, s: State) -> bool:
        """Drain-collapse precondition (see module docstring)."""
        if s.delivered < len(self.batches) or not s.inflight:
            return False
        if len(s.inflight) < 2:
            return False                       # nothing to collapse
        if not s.pending:
            return True
        inflight_sids = {sid for job in s.inflight for sid, _ in job.pairs}
        if any(sid in inflight_sids for sid, _ in s.pending):
            return False                       # missing_of would shift
        _p, _f, _rr, adm, _inv = self._kick(s.pending, frozenset(), s.rr)
        return not adm

    def successors(self, s: State) -> list[tuple[Step, State]]:
        if self.por and self._can_drain(s):
            self._pruned += math.factorial(len(s.inflight)) - 1
            done = Step(("drain",), ())
            return [(done, State(pending=s.pending, inflight=frozenset(),
                                 delivered=s.delivered, rr=s.rr))]
        out: list[tuple[Step, State]] = []
        if s.delivered < len(self.batches):
            pend = s.pending + self.batches[s.delivered]
            p2, f2, rr2, adm, inv = self._kick(pend, s.inflight, s.rr)
            step = Step(("deliver", s.delivered), adm)
            self._note_kick(step, inv)
            out.append((step, State(p2, f2, s.delivered + 1, rr2)))
        for job in sorted(s.inflight, key=lambda j: j.pairs):
            rest = s.inflight - {job}
            p2, f2, rr2, adm, inv = self._kick(s.pending, rest, s.rr)
            step = Step(("complete", job.pairs), adm)
            self._note_kick(step, inv)
            out.append((step, State(p2, f2, s.delivered, rr2)))
        return out

    def _note_kick(self, step: Step, inversions: list[Violation]) -> None:
        self._kick_inversions[step] = inversions

    # -- property checks -----------------------------------------------------
    def _check_link_safety(self, s: State) -> str | None:
        totals: dict[LinkKey, Fraction] = {}
        for job in s.inflight:
            for key, r in job.rates:
                totals[key] = totals.get(key, Fraction(0)) + Fraction(r)
        slack = Fraction(1) + Fraction(RESERVATION_EPS)
        for key, tot in totals.items():
            cap = self.core.net.link_capacity(key)
            if math.isinf(cap):
                continue
            if tot > Fraction(cap) * slack:
                return (f"link {key} oversubscribed: "
                        f"sum(rates)={float(tot):.6g} > "
                        f"capacity={cap:.6g}")
        return None

    def _check_work_conservation(self, s: State) -> str | None:
        """Independent fixed-point check: no group the scheduler's scan
        would admit is left pending."""
        if not s.pending:
            return None
        if (self.max_inflight is not None
                and len(s.inflight) >= self.max_inflight):
            return None
        missing = self._missing_map(s.pending, s.inflight)

        def missing_of(sid: int) -> AbstractSet[int]:
            return missing.get(sid, frozenset())

        used = self._used(s.inflight)
        cands = self.core.candidate_groups(s.pending, missing_of, s.rr)
        for _key, group in cands:
            if not self.use_links:
                return f"pipe mode left {sorted(group)} pending while idle"
            hours, _label, merged = self.core.job_cost(group, missing_of)
            rates = flow_rates(self.core.net, merged, hours)
            if reservation_fits(used, rates, self.core.net.link_capacity,
                                ignore_residual=self.unsafe):
                return (f"admissible group {sorted(group)} left pending "
                        f"(residuals would fit it)")
            if self.max_inflight == 1:
                return None      # serial link mode scans only the head
        return None

    def _urgent_inversion_width(self, s: State) -> int:
        """# lower-tier in-flight jobs while an URGENT group is pending."""
        if not s.pending:
            return 0
        missing = self._missing_map(s.pending, s.inflight)

        def missing_of(sid: int) -> AbstractSet[int]:
            return missing.get(sid, frozenset())

        urgent_waiting = any(
            int(self.core.job_tier(group, missing_of)) == int(Priority.URGENT)
            for _k, group in self.core.candidate_groups(
                s.pending, missing_of, s.rr))
        if not urgent_waiting:
            return 0
        return sum(1 for job in s.inflight
                   if job.tier > int(Priority.URGENT))

    # -- exploration ---------------------------------------------------------
    def explore(self) -> ExploreResult:
        res = ExploreResult()
        props = {name: True for name in PROPERTIES}
        self._pruned = 0
        self._kick_inversions: dict[Step, list[Violation]] = {}
        root = self.initial()
        parent: dict[State, tuple[State, Step] | None] = {root: None}
        queue: deque[State] = deque([root])
        res.states = 1

        def trace_to(s: State) -> tuple[Step, ...]:
            steps: list[Step] = []
            cur: State | None = s
            while cur is not None:
                link = parent[cur]
                if link is None:
                    break
                prev, step = link
                steps.append(step)
                cur = prev
            return tuple(reversed(steps))

        def fail(prop: str, s: State, detail: str,
                 extra: tuple[Step, ...] = ()) -> None:
            props[prop] = False
            if len(res.violations) < 16:        # keep reports bounded
                res.violations.append(
                    Violation(prop, detail, trace_to(s) + extra))

        while queue:
            s = queue.popleft()
            res.max_inflight_seen = max(res.max_inflight_seen,
                                        len(s.inflight))
            detail = self._check_link_safety(s)
            if detail is not None:
                fail("link_safety", s, detail)
            detail = self._check_work_conservation(s)
            if detail is not None:
                fail("work_conservation", s, detail)
            res.inversion_width = max(res.inversion_width,
                                      self._urgent_inversion_width(s))
            succs = self.successors(s)
            if self.pipe_expected and len(succs) > 1:
                fail("pipe_determinism", s,
                     f"pipe-mode state has {len(succs)} successors")
            if not succs:
                res.terminals += 1
                if s.pending or s.inflight:
                    left = sorted(s.pending) + sorted(
                        p for j in s.inflight for p in j.pairs)
                    fail("deadlock_freedom", s,
                         f"terminal state with unfinished work {left}")
                if s.repaired_count(self.total_pairs) != self.total_pairs:
                    fail("starvation_freedom", s,
                         "terminal state is not fully repaired: "
                         f"{s.repaired_count(self.total_pairs)}"
                         f"/{self.total_pairs} pairs")
                continue
            measure = (s.delivered, s.repaired_count(self.total_pairs))
            for step, nxt in succs:
                res.transitions += 1
                res.admissions += len(step.admissions)
                for adm in step.admissions:
                    if self.pipe_expected and adm.cand_index != 0:
                        fail("pipe_determinism", s,
                             f"admission of {list(adm.pairs)} skipped "
                             f"{adm.cand_index} frozen-order candidates",
                             (step,))
                for inv in self._kick_inversions.pop(step, []):
                    props["bounded_priority_inversion"] = False
                    if len(res.violations) < 16:
                        res.violations.append(dataclasses.replace(
                            inv, trace=trace_to(s) + (step,)))
                nm = (nxt.delivered, nxt.repaired_count(self.total_pairs))
                assert nm > measure, "transition must increase the measure"
                if nxt not in parent:
                    parent[nxt] = (s, step)
                    queue.append(nxt)
                    res.states += 1
                    if res.states > self.max_states:
                        res.exhaustive = False
                        res.properties = props
                        return res
        res.pruned_orderings = self._pruned
        res.properties = props
        return res

    # -- timed canonical trace (for the differential harness) ----------------
    def timed_trace(self, batch_times: Any) -> list[dict[str, Any]]:
        """Execute the ONE timed run the real `Simulator` would: batch i
        lands at `batch_times[i]`, each admission finishes at
        admit_time + hours, ties break by schedule order (damage events
        are scheduled first, seq 0..B-1, completions after — exactly
        the harness's seeding order). Returns the event list the real
        run's observer must reproduce verbatim: one record per
        delivery/completion, each carrying the kick's admissions."""
        times = [float(t) for t in batch_times]
        if len(times) != len(self.batches):
            raise ValueError("need one batch time per batch")
        if sorted(times) != times:
            raise ValueError("batch times must be non-decreasing")
        heap: list[tuple[float, int, str, Any]] = [
            (t, i, "deliver", i) for i, t in enumerate(times)]
        seq = len(times)
        pending: tuple[Pair, ...] = ()
        inflight: frozenset[Job] = frozenset()
        live: dict[Job, tuple[float, int]] = {}   # job -> (finish, seq)
        rr = 0
        out: list[dict[str, Any]] = []
        while heap:
            heap.sort()
            now, _sq, kind, payload = heap.pop(0)
            if kind == "deliver":
                pending = pending + self.batches[int(payload)]
                event: dict[str, Any] = {"t": now, "kind": "deliver",
                                         "batch": int(payload)}
            else:
                job = payload
                inflight = inflight - {job}
                del live[job]
                event = {"t": now, "kind": "complete",
                         "pairs": list(job.pairs)}
            pending, inflight, rr, adm, _inv = self._kick(
                pending, inflight, rr)
            for a in adm:
                job = next(j for j in inflight if j.pairs == a.pairs
                           and j not in live)
                live[job] = (now + a.hours, seq)
                heap.append((now + a.hours, seq, "complete", job))
                seq += 1
            event["admissions"] = [
                {"pairs": list(a.pairs), "tier": a.tier, "hours": a.hours,
                 "bottleneck": a.bottleneck, "rates": list(a.rates)}
                for a in adm]
            out.append(event)
        if pending or inflight:
            raise AssertionError("timed trace did not drain "
                                 f"(pending={pending!r})")
        return out
