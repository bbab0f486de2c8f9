"""Scheduler model checking: bounded scenarios, certificates, replay (the
port's copy of `repro.analysis.schedcheck`, run against the port's
simulator).

`repro_torch.analysis.model.SchedModel` turns the repair scheduler's shared
pure core (`sim.repair.SchedCore`) into an exhaustively explorable
transition system. This module supplies everything around it:

  * a **scenario grid** — small, hand-chosen damage workloads over
    UniLRC(1, 3) (12 blocks, 3 clusters) that exercise every scheduler
    mechanism: a correlated cluster-loss burst, a mixed-tier queue,
    staged arrivals under an in-flight cap, detection-window overlap
    of multi-failure jobs, pipe-mode serialization, and same-cluster
    contention with skip-ahead;
  * a **differential harness** — each scenario's canonical *timed*
    trace (the one schedule of deliveries and completions the real
    event loop produces) is computed from the abstract model and then
    replayed through the real `Simulator`/`RepairScheduler`, asserting
    step-for-step agreement on every admission and completion (pairs,
    tier, duration, bottleneck, per-link rates). Untimed interleavings
    need no replay: model and simulator call the same `SchedCore`
    functions, so they can only disagree about event *order*, which is
    precisely what the timed comparison pins;
  * **counterexample replay** — re-introducing the oversubscribing
    admission variant (`unsafe_ignore_residual`) makes the explorer
    emit a BFS-minimal violating trace, and `replay_counterexample`
    drives the real scheduler (flag enabled) through the same damage
    prefix and confirms the identical oversubscription on the same
    link — the model's bug reports are executable;
  * **certificates** — one versioned `Certificate` per scenario (six
    property claims + model/sim agreement + state-space sizes), with
    the kernel-launch delta recorded (must be zero: model checking is
    pure host-side control-flow, no kernel bytes move).

CLI::

    python -m repro_torch.analysis.schedcheck --grid \
        [--out schedcheck.json] [--scenario NAME]
    python -m repro_torch.analysis.schedcheck --broken     # demo the bug hunt

`benchmarks/check_regression.py --sched-model` gates CI on the grid
output.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import pathlib
import sys
from typing import Any

from repro_torch.core.codes import make_unilrc
from repro_torch.core.mttdl import MTTDLParams
from repro_torch.core.placement import default_placement
from repro_torch.priority import tier_label
from repro_torch.topo import Topology

from .certificate import Certificate, Claim, dump_certificates
from .model import PROPERTIES, ExploreResult, SchedModel, Violation
from .verify import _launch_total

Pair = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One bounded workload: damage batches over the reference code."""
    name: str
    description: str
    batches: tuple[tuple[Pair, ...], ...]
    batch_times: tuple[float, ...]
    link_mode: bool = True
    max_inflight: int | None = None
    block_TB: float = 0.25


def _reference_system() -> tuple[Any, Any, Any]:
    """(code, placement, params) every scenario runs on: UniLRC(1, 3) —
    n=12, k=6, three clusters of four blocks, f=4 tolerable failures,
    so all three risk tiers are reachable."""
    code = make_unilrc(1, 3)
    placement = default_placement(code)
    return code, placement, MTTDLParams()


def scenario_grid() -> list[Scenario]:
    """The bounded scenarios the grid explores (<=6 damaged pairs,
    3 clusters — small enough for exhaustive interleaving search,
    rich enough to cover every admission mechanism)."""
    _code, pl, _params = _reference_system()
    c0 = sorted(pl.cluster_blocks(0))
    c1 = sorted(pl.cluster_blocks(1))
    c2 = sorted(pl.cluster_blocks(2))
    return [
        Scenario(
            name="cluster_burst",
            description="correlated cluster-0 loss: one stripe loses all "
                        "four cluster-0 blocks (URGENT, at the exposure "
                        "edge) while another stripe holds a cross-cluster "
                        "double (EXPEDITED)",
            batches=(((0, c0[0]), (0, c0[1]), (0, c0[2]), (0, c0[3]),
                      (1, c1[0]), (1, c2[0])),),
            batch_times=(0.0,)),
        Scenario(
            name="mixed_tier",
            description="mixed-tier queue: three NORMAL singles (two "
                        "contending for cluster 0) plus an EXPEDITED "
                        "in-group double",
            batches=(((1, c0[0]), (2, c0[1]), (3, c1[0]),
                      (4, c2[0]), (4, c2[1])),),
            batch_times=(0.0,)),
        Scenario(
            name="staged_arrivals",
            description="two damage waves under max_inflight=2: singles "
                        "land first, an EXPEDITED double arrives while "
                        "they are in flight",
            batches=(((0, c0[0]), (1, c1[0])),
                     ((2, c2[0]), (2, c2[1]), (3, c0[1]))),
            batch_times=(0.0, 1e-4),
            max_inflight=2),
        Scenario(
            name="detection_window",
            description="detection-limited overlap: two multi-failure "
                        "stripes whose tiny transfers are stretched to "
                        "the T_hours detection floor share cluster-0 "
                        "links at fractional rates",
            batches=(((0, c0[0]), (0, c0[1]), (1, c0[2]), (1, c0[3]),
                      (2, c1[0])),),
            batch_times=(0.0,),
            block_TB=0.002),
        Scenario(
            name="pipe_serial",
            description="pipe mode (no topology): the Markov-calibrated "
                        "serial scheduler must produce the single frozen "
                        "(multi-first, block-order) trace",
            batches=(((0, c0[0]), (0, c0[1]), (1, c1[0]), (2, c2[0])),),
            batch_times=(0.0,),
            link_mode=False),
        Scenario(
            name="skip_ahead",
            description="same-cluster contention: two cluster-0 singles "
                        "serialize on the ingest link while skip-ahead "
                        "admits the disjoint cluster-1/2 singles past "
                        "the blocked one",
            batches=(((0, c0[0]), (1, c0[1]), (2, c1[0]), (3, c2[0])),),
            batch_times=(0.0,)),
    ]


def broken_scenario() -> Scenario:
    """The counterexample hunt's workload: three singles that all
    bottleneck on cluster-0 ingest. A correct scheduler serializes
    them; the `unsafe_ignore_residual` variant admits all three at
    once, tripling the load on one link."""
    _code, pl, _params = _reference_system()
    c0 = sorted(pl.cluster_blocks(0))
    return Scenario(
        name="broken_admission",
        description="three cluster-0 singles vs the oversubscribing "
                    "admission variant",
        batches=(((0, c0[0]), (1, c0[1]), (2, c0[2])),),
        batch_times=(0.0,))


def build_model(scn: Scenario, *, unsafe: bool = False,
                por: bool = True) -> SchedModel:
    from repro_torch.sim.repair import SchedCore
    _code, pl, params = _reference_system()
    topo = Topology(pl.num_clusters, 4) if scn.link_mode else None
    core = SchedCore(pl, params, block_TB=scn.block_TB, topology=topo)
    return SchedModel(core, scn.batches, max_inflight=scn.max_inflight,
                      unsafe=unsafe, por=por,
                      pipe_expected=not scn.link_mode)


# ---------------------------------------------------------------------------
# Differential harness: abstract timed trace vs the real Simulator
# ---------------------------------------------------------------------------

class _TraceObserver:
    """Records the real scheduler's admissions/completions in order."""

    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []

    def admitted(self, group: Any, tier: Any, hours: float,
                 bottleneck: str, rates: dict[tuple, float]) -> None:
        self.events.append({"kind": "admit",
                            "pairs": sorted(group), "tier": int(tier),
                            "hours": float(hours),
                            "bottleneck": str(bottleneck),
                            "rates": sorted(rates.items())})

    def completed(self, group: Any) -> None:
        self.events.append({"kind": "complete", "pairs": sorted(group)})


def run_real(scn: Scenario, *, unsafe: bool = False
             ) -> tuple[list[dict[str, Any]], Any]:
    """Drive the real event-driven scheduler through the scenario.
    Returns (flat event list in simulator order, scheduler) — the list
    interleaves deliveries with the observer's admissions/completions,
    the exact stream `timed_trace` predicts."""
    from repro_torch.sim import RepairScheduler, Simulator
    _code, pl, params = _reference_system()
    topo = Topology(pl.num_clusters, 4) if scn.link_mode else None
    sim = Simulator()
    obs = _TraceObserver()
    missing: dict[int, set[int]] = {}

    def on_repaired(done: list[Pair]) -> None:
        for sid, b in done:
            missing.get(sid, set()).discard(b)

    sched = RepairScheduler(
        sim, pl, params, block_TB=scn.block_TB,
        stripe_missing=lambda sid: missing.get(sid, frozenset()),
        on_repaired=on_repaired, topology=topo,
        max_inflight=scn.max_inflight, observer=obs,
        unsafe_admission=unsafe)

    def on_damage(sim: Any, ev: Any) -> None:
        batch = ev.payload["pairs"]
        for sid, b in batch:
            missing.setdefault(sid, set()).add(b)
        obs.events.append({"kind": "deliver",
                           "batch": int(ev.payload["index"])})
        sched.damaged(list(batch))

    sim.on("SCHEDCHECK_DAMAGE", on_damage)
    # Damage events are seeded first (seq 0..B-1), completions after —
    # the same tie-break order `SchedModel.timed_trace` assumes.
    for i, (t, batch) in enumerate(zip(scn.batch_times, scn.batches)):
        sim.schedule_at(t, "SCHEDCHECK_DAMAGE", pairs=list(batch), index=i)
    sim.run()
    return obs.events, sched


def _flatten_model_trace(trace: list[dict[str, Any]]
                         ) -> list[dict[str, Any]]:
    """The timed model trace in the real observer's flat event shape.
    Ordering mirrors the scheduler: a completion fires its `completed`
    hook before the post-release kick's admissions, a delivery logs
    before its kick admits."""
    flat: list[dict[str, Any]] = []
    for ev in trace:
        if ev["kind"] == "deliver":
            flat.append({"kind": "deliver", "batch": ev["batch"]})
        else:
            flat.append({"kind": "complete", "pairs": ev["pairs"]})
        for adm in ev["admissions"]:
            flat.append({"kind": "admit", "pairs": list(adm["pairs"]),
                         "tier": adm["tier"], "hours": adm["hours"],
                         "bottleneck": adm["bottleneck"],
                         "rates": list(adm["rates"])})
    return flat


def _events_agree(model_ev: dict[str, Any], real_ev: dict[str, Any],
                  *, rel: float = 1e-9) -> bool:
    if model_ev["kind"] != real_ev["kind"]:
        return False
    if model_ev["kind"] == "deliver":
        return bool(model_ev["batch"] == real_ev["batch"])
    if sorted(model_ev["pairs"]) != sorted(real_ev["pairs"]):
        return False
    if model_ev["kind"] == "complete":
        return True
    if model_ev["tier"] != real_ev["tier"]:
        return False
    if model_ev["bottleneck"] != real_ev["bottleneck"]:
        return False
    if not math.isclose(model_ev["hours"], real_ev["hours"], rel_tol=rel):
        return False
    mr = [(tuple(k), v) for k, v in model_ev["rates"]]
    rr = [(tuple(k), v) for k, v in real_ev["rates"]]
    if [k for k, _ in mr] != [k for k, _ in rr]:
        return False
    return all(math.isclose(a, b, rel_tol=rel, abs_tol=1e-15)
               for (_, a), (_, b) in zip(mr, rr))


def differential_check(scn: Scenario, *, unsafe: bool = False
                       ) -> tuple[bool, str, int]:
    """Replay the scenario's canonical timed trace through the real
    Simulator and compare step-for-step. Returns (agree, detail,
    steps_compared)."""
    model = build_model(scn, unsafe=unsafe)
    predicted = _flatten_model_trace(model.timed_trace(scn.batch_times))
    observed, _sched = run_real(scn, unsafe=unsafe)
    n = max(len(predicted), len(observed))
    for i in range(n):
        if i >= len(predicted) or i >= len(observed):
            return (False,
                    f"step {i}: trace lengths differ "
                    f"(model={len(predicted)}, sim={len(observed)})", i)
        if not _events_agree(predicted[i], observed[i]):
            return (False,
                    f"step {i}: model {predicted[i]!r} "
                    f"!= sim {observed[i]!r}", i)
    return True, f"all {n} timed steps agree", n


# ---------------------------------------------------------------------------
# Counterexample replay
# ---------------------------------------------------------------------------

def find_counterexample(scn: Scenario, prop: str = "link_safety"
                        ) -> Violation | None:
    """Explore the scenario under the broken admission rule; returns
    the BFS-minimal violating trace (None if the property holds)."""
    res = build_model(scn, unsafe=True).explore()
    return res.first_violation(prop)


def replay_counterexample(scn: Scenario, violation: Violation
                          ) -> tuple[bool, str]:
    """Execute a link_safety counterexample in the real Simulator with
    the broken admission flag enabled and confirm the same
    oversubscription occurs: the violating admissions all happen, and
    the per-link rate sum exceeds capacity on the link the model named.

    Replay is exact for delivery-prefix traces (the hunt scenario's
    violation fires during the first kick, before any completion, so
    the timed run necessarily passes through the violating state)."""
    if violation.prop != "link_safety":
        return False, f"can only replay link_safety, got {violation.prop}"
    if any(step.event[0] == "complete" for step in violation.trace):
        return False, ("trace interleaves completions; the timed replay "
                       "only pins delivery-prefix counterexamples")
    events, sched = run_real(scn, unsafe=True)
    want = [tuple(a.pairs) for step in violation.trace
            for a in step.admissions]
    got = [tuple(tuple(p) for p in ev["pairs"]) for ev in events
           if ev["kind"] == "admit"][:len(want)]
    if got != want:
        return False, (f"admission prefix differs: model {want!r} "
                       f"vs sim {got!r}")
    peak = sched.reservations.peak_utilization
    if peak <= 1.0 + 1e-6:
        return False, f"simulator never oversubscribed (peak={peak:.3f})"
    return True, (f"simulator reproduced the violation: peak link "
                  f"utilization {peak:.2f}x capacity after admissions "
                  f"{[list(w) for w in want]}")


# ---------------------------------------------------------------------------
# Certification
# ---------------------------------------------------------------------------

def _property_claims(scn: Scenario, res: ExploreResult) -> list[Claim]:
    method = (f"exhaustive(states={res.states},"
              f"transitions={res.transitions})")
    claims: list[Claim] = []
    for prop in PROPERTIES:
        ok = res.properties.get(prop, False) and res.exhaustive
        viol = res.first_violation(prop)
        if prop == "pipe_determinism" and scn.link_mode:
            claims.append(Claim(
                name=prop, ok=True, method="n/a",
                detail="link-mode scenario: the determinism certificate "
                       "is established by the pipe_serial scenario"))
            continue
        detail = (f"holds in all {res.states} reachable states" if ok
                  else (viol.detail if viol is not None
                        else "state budget exhausted before completion"))
        data: dict[str, Any] = {}
        if prop == "bounded_priority_inversion":
            data["inversion_width"] = res.inversion_width
        if viol is not None:
            data["counterexample"] = viol.to_dict()
        claims.append(Claim(name=prop, ok=ok, method=method,
                            detail=detail, data=data))
    return claims


def check_scenario(scn: Scenario) -> Certificate:
    """Explore one scenario exhaustively, run the differential harness,
    and emit the certificate."""
    launches0 = _launch_total()
    res = build_model(scn).explore()
    claims = _property_claims(scn, res)
    agree, detail, steps = differential_check(scn)
    claims.append(Claim(
        name="model_sim_agreement", ok=agree,
        method=f"differential(timed_steps={steps})", detail=detail,
        data={"steps": steps}))
    code, _pl, _params = _reference_system()
    tiers = sorted({tier_label(a.tier)          # type: ignore[arg-type]
                    for v in res.violations for s in v.trace
                    for a in s.admissions})
    params: dict[str, Any] = {
        "scenario": scn.name,
        "description": scn.description,
        "mode": "link" if scn.link_mode else "pipe",
        "pairs": sum(len(b) for b in scn.batches),
        "batches": len(scn.batches),
        "max_inflight": scn.max_inflight,
        "block_TB": scn.block_TB,
        "states": res.states,
        "transitions": res.transitions,
        "terminal_states": res.terminals,
        "pruned_orderings": res.pruned_orderings,
        "max_concurrent_jobs": res.max_inflight_seen,
        "admissions": res.admissions,
    }
    if tiers:
        params["violating_tiers"] = tiers
    return Certificate(
        code_name=code.name, placement_name=f"sched/{scn.name}",
        params=params, claims=tuple(claims),
        kernel_launches=_launch_total() - launches0)


def check_grid() -> list[Certificate]:
    return [check_scenario(scn) for scn in scenario_grid()]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Exhaustively model-check the repair scheduler "
                    "(no kernels).")
    ap.add_argument("--grid", action="store_true",
                    help="explore every bounded scenario")
    ap.add_argument("--scenario", type=str,
                    help="explore one scenario by name")
    ap.add_argument("--broken", action="store_true",
                    help="demo: hunt + replay the oversubscription bug")
    ap.add_argument("--out", type=pathlib.Path,
                    help="write the certificate batch JSON here")
    args = ap.parse_args(argv)

    if args.broken:
        scn = broken_scenario()
        viol = find_counterexample(scn)
        if viol is None:
            print("no counterexample found — the broken variant did not "
                  "misbehave", file=sys.stderr)
            return 1
        print(f"minimal counterexample ({len(viol.trace)} events): "
              f"{viol.detail}")
        for step in viol.trace:
            print(f"  {step.event}  admissions="
                  f"{[list(a.pairs) for a in step.admissions]}")
        ok, detail = replay_counterexample(scn, viol)
        print(("replay OK: " if ok else "replay FAILED: ") + detail)
        return 0 if ok else 1

    if args.scenario:
        wanted = [s for s in scenario_grid() if s.name == args.scenario]
        if not wanted:
            names = ", ".join(s.name for s in scenario_grid())
            ap.error(f"unknown scenario {args.scenario!r} (have: {names})")
        certs = [check_scenario(wanted[0])]
    elif args.grid:
        certs = check_grid()
    else:
        ap.error("pass --grid, --scenario NAME, or --broken")
        return 2

    for cert in certs:
        p = cert.params
        print(f"{cert.summary()}  "
              f"[{p['states']} states, {p['transitions']} transitions, "
              f"{p['pruned_orderings']} orderings pruned]")
        for claim in cert.failures():
            print(f"  FAIL {claim.name} [{claim.method}]: {claim.detail}",
                  file=sys.stderr)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(dump_certificates(certs))
        print(f"wrote {args.out}")
    return 0 if all(c.all_ok and c.kernel_launches == 0 for c in certs) else 1


if __name__ == "__main__":
    sys.exit(main())
