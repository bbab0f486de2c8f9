"""Static hazard analysis over a queued `CodingEngine` flush (port of
`repro.analysis.hazards`).

An op-ordering hazard — a partial update that writes the new data block
*before* reading the old value its parity delta needs, so the delta folds
to zero and parities go stale — corrupts data without failing any
byte-level test until the corrupt block is read. This module proves such
orderings impossible *before a single byte moves*, by building the
RAW/WAW/WAR dependency graph over (stripe, block) store locations for
everything the engine has queued and checking the schedule the flush
would execute:

  * every coalesced update wave is **conflict-free** — one op per
    stripe, so no two ops in a wave touch overlapping locations
    (no intra-wave WAW/WAR/RAW between siblings);
  * every wave is **staged** — ALL reads precede ANY write (the
    stripe-intact-on-failure invariant), and in particular no location
    is read after the wave already wrote it (caught as a
    `read-after-write` hazard on the data block);
  * waves are **ordered** — updates to the same stripe execute in
    submission order across waves (cross-wave RAW is *intended*: a
    later wave must see an earlier wave's parity writes);
  * the read/recover/encode prelude is **read-only** — recovery plans
    read sources, they never write the store mid-flush.

The checker operates on an explicit `Step` sequence, so tests can feed
it hand-built schedules. `CodingEngine.flush(analyze=True)` runs
`analyze_flush` on the pending queue and raises `HazardViolation` (with
the offending op pair) before executing anything.

The CLI replays the reference's three engine workloads on the port and
proves each flush clean, on the card unless asked for the CPU (the
workloads' writes launch the coding kernels; the analysis itself runs
none):

    python -m repro_torch.analysis.hazards [--out report.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
from typing import Any

import numpy as np

from repro_torch.core.codec import decode_plan_cached, plans_for

Loc = tuple[int, int]   # (stripe id, block id)


class HazardViolation(Exception):
    """A statically-detected ordering hazard in a flush schedule.

    `kind` is one of:
      * ``read-after-write`` — a location is read after the same wave
        already wrote it (the stale-parity shape);
      * ``staged-order``     — a read step follows a write step in a
        wave (all-reads-before-any-write broken, even across locations);
      * ``wave-conflict``    — two sibling ops in one wave touch
        overlapping locations (intra-wave WAW/WAR/RAW);
      * ``wave-reorder``     — same-stripe updates scheduled against
        submission order across waves.
    """

    def __init__(self, kind: str, loc: Loc | None,
                 first: str, second: str, wave: int = -1):
        self.kind = kind
        self.loc = loc
        self.first = first
        self.second = second
        self.wave = wave
        at = f" at (stripe {loc[0]}, block {loc[1]})" if loc else ""
        wv = f" in wave {wave}" if wave >= 0 else ""
        super().__init__(f"{kind}{at}{wv}: {first} vs {second}")

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "loc": list(self.loc) if self.loc else None,
                "first": self.first, "second": self.second, "wave": self.wave}


@dataclasses.dataclass(frozen=True)
class OpAccess:
    """One queued op's store footprint: which locations it reads and
    which it writes, derived without executing it."""
    index: int                      # submission position in the queue
    kind: str                       # 'read' | 'recover' | 'encode' | 'update'
    stripe: int
    block: int
    reads: tuple[Loc, ...]
    writes: tuple[Loc, ...] = ()

    def describe(self) -> str:
        return f"op#{self.index} {self.kind}(stripe={self.stripe}, " \
               f"block={self.block})"


@dataclasses.dataclass(frozen=True)
class Step:
    """One scheduled store access: `op` (index into the wave's ops),
    'read' or 'write', one location."""
    op: int
    action: str                     # 'read' | 'write'
    loc: Loc


@dataclasses.dataclass(frozen=True)
class Wave:
    """One coalesced update wave: its member ops and the exact step
    sequence the engine would execute (stage reads, then apply
    writes)."""
    index: int
    ops: tuple[OpAccess, ...]
    steps: tuple[Step, ...]


@dataclasses.dataclass(frozen=True)
class FlushSchedule:
    """The full static schedule of one flush: the read-only prelude
    (encodes, reads, recovers — in engine execution order) followed by
    the mutating update waves."""
    prelude: tuple[OpAccess, ...]
    waves: tuple[Wave, ...]

    @property
    def num_ops(self) -> int:
        return len(self.prelude) + sum(len(w.ops) for w in self.waves)


# ---------------------------------------------------------------------------
# Footprint derivation — mirrors engine planning, executes nothing
# ---------------------------------------------------------------------------

def _recover_reads(code: Any, store: Any, stripe: int, block: int
                   ) -> tuple[Loc, ...]:
    """The source blocks a recover op will read, under the store's
    CURRENT availability — the same fast-plan/pattern-decode choice
    `CodingEngine._recover_cluster_group` makes."""
    plans = plans_for(code)
    eset = {b for b in range(code.n) if not store.available(stripe, b)}
    if not eset.intersection(plans[block].sources):
        return tuple((stripe, s) for s in plans[block].sources)
    pattern = tuple(sorted(eset | {block}))
    try:
        dplan = decode_plan_cached(code, pattern)
    except ValueError:
        return ()                   # beyond tolerance: op fails, reads nothing
    return tuple((stripe, s) for s in dplan.sources)


def _update_footprint(code: Any, stripe: int, block: int
                      ) -> tuple[Loc, ...]:
    """A delta update reads-then-writes its data block plus every parity
    with a nonzero coefficient on it (engine `touched_of`)."""
    touched = [int(pi) for pi in np.flatnonzero(code.A[:, block])]
    return ((stripe, block),
            *((stripe, code.k + pi) for pi in touched))


def op_access(code: Any, store: Any, op: Any, index: int) -> OpAccess:
    """Static footprint of one queued `_Op`."""
    if op.kind == "read":
        return OpAccess(index, "read", op.stripe, op.block,
                        reads=((op.stripe, op.block),))
    if op.kind == "recover":
        return OpAccess(index, "recover", op.stripe, op.block,
                        reads=_recover_reads(code, store, op.stripe,
                                             op.block))
    if op.kind == "encode":
        return OpAccess(index, "encode", op.stripe, op.block, reads=())
    if op.kind == "update":
        fp = _update_footprint(code, op.stripe, op.block)
        return OpAccess(index, "update", op.stripe, op.block,
                        reads=fp, writes=fp)
    raise ValueError(f"unknown op kind {op.kind!r}")


def staged_wave(index: int, ops: tuple[OpAccess, ...]) -> Wave:
    """The step sequence `_run_update_wave` executes: EVERY read of
    every member op, then every write — the staging discipline the
    checker proves."""
    steps = [Step(u, "read", loc)
             for u, op in enumerate(ops) for loc in op.reads]
    steps += [Step(u, "write", loc)
              for u, op in enumerate(ops) for loc in op.writes]
    return Wave(index, ops, tuple(steps))


def flush_schedule(engine: Any) -> FlushSchedule:
    """Static schedule of `engine`'s pending queue, replicating flush
    execution order (encodes, reads, recovers, then update waves) and
    the coalescer's wave-partition rule: submission order, one op per
    stripe per wave, uniform (payload length, reader cluster) per
    wave."""
    accesses = [op_access(engine.code, engine.store, op, i)
                for i, op in enumerate(engine._pending)]
    kinds = {a.index: a for a in accesses}
    order = {"encode": 0, "read": 1, "recover": 2}
    prelude = tuple(sorted(
        (a for a in accesses if a.kind != "update"),
        key=lambda a: (order[a.kind], a.index)))

    pending_updates = [engine._pending[a.index] for a in accesses
                       if a.kind == "update"]
    remaining = list(pending_updates)
    waves: list[Wave] = []
    while remaining:
        wave_ops: list[OpAccess] = []
        stripes: set[int] = set()
        key = None
        deferred = []
        for op in remaining:
            okey = (len(op.new_data), op.reader_cluster)
            if op.stripe in stripes or (key is not None and okey != key):
                deferred.append(op)
                stripes.add(op.stripe)
                continue
            key = okey
            stripes.add(op.stripe)
            wave_ops.append(kinds[engine._pending.index(op)])
        remaining = deferred
        waves.append(staged_wave(len(waves), tuple(wave_ops)))
    return FlushSchedule(prelude, tuple(waves))


# ---------------------------------------------------------------------------
# The prover
# ---------------------------------------------------------------------------

def check_wave(wave: Wave) -> list[HazardViolation]:
    """Prove one wave conflict-free and correctly staged.

    Checks, in order of precision: sibling-op footprint overlap
    (``wave-conflict``), a read of a location the wave already wrote
    (``read-after-write`` — the stale-parity bug), and any read step after any
    write step (``staged-order``)."""
    out: list[HazardViolation] = []
    for i, a in enumerate(wave.ops):
        fa = set(a.reads) | set(a.writes)
        for b in wave.ops[i + 1:]:
            overlap = (set(b.writes) & fa) | (set(a.writes) & set(b.reads))
            if overlap:
                out.append(HazardViolation(
                    "wave-conflict", min(overlap), a.describe(),
                    b.describe(), wave.index))
    written: dict[Loc, int] = {}
    writes_seen = False
    first_writer = -1
    for step in wave.steps:
        if step.action == "write":
            writes_seen = True
            if first_writer < 0:
                first_writer = step.op
            written.setdefault(step.loc, step.op)
            continue
        who = wave.ops[step.op].describe() if step.op < len(wave.ops) \
            else f"op#{step.op}"
        if step.loc in written:
            writer = written[step.loc]
            wdesc = wave.ops[writer].describe() if writer < len(wave.ops) \
                else f"op#{writer}"
            out.append(HazardViolation(
                "read-after-write", step.loc, wdesc + " (write)",
                who + " (stale read)", wave.index))
        elif writes_seen:
            wdesc = (wave.ops[first_writer].describe()
                     if 0 <= first_writer < len(wave.ops)
                     else f"op#{first_writer}")
            out.append(HazardViolation(
                "staged-order", step.loc, wdesc + " (write)",
                who + " (late read)", wave.index))
    return out


def check_schedule(sched: FlushSchedule) -> list[HazardViolation]:
    """Prove a full flush schedule hazard-free.

    Prelude ops must be read-only; each wave passes `check_wave`; and
    same-location updates execute across waves in submission order
    (cross-wave RAW is intended — later waves see earlier parity
    writes — but only in queue order)."""
    out: list[HazardViolation] = []
    for a in sched.prelude:
        if a.writes:
            out.append(HazardViolation(
                "wave-conflict", a.writes[0], a.describe(),
                "read-only prelude", -1))
    for wave in sched.waves:
        out.extend(check_wave(wave))
    last_seen: dict[Loc, tuple[int, OpAccess]] = {}
    for wave in sched.waves:
        for op in wave.ops:
            for loc in set(op.reads) | set(op.writes):
                prev = last_seen.get(loc)
                if prev is not None and prev[1].index > op.index:
                    out.append(HazardViolation(
                        "wave-reorder", loc, prev[1].describe(),
                        op.describe(), wave.index))
                last_seen[loc] = (wave.index, op)
    return out


@dataclasses.dataclass
class HazardReport:
    """Result of analyzing one queued flush."""
    ops: int
    waves: int
    violations: list[HazardViolation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict[str, Any]:
        return {"ops": self.ops, "waves": self.waves,
                "ok": self.ok,
                "violations": [v.to_dict() for v in self.violations]}


def analyze_flush(engine: Any, *, raise_on_violation: bool = False
                  ) -> HazardReport:
    """Statically analyze everything `engine` has queued, without
    executing any of it. With `raise_on_violation` (what
    `flush(analyze=True)` uses) the first hazard raises
    `HazardViolation`."""
    sched = flush_schedule(engine)
    violations = check_schedule(sched)
    if violations and raise_on_violation:
        raise violations[0]
    return HazardReport(ops=sched.num_ops, waves=len(sched.waves),
                        violations=violations)


# ---------------------------------------------------------------------------
# CLI: replay representative engine workloads and prove them clean
# ---------------------------------------------------------------------------

def _workload_reports(device: str = "cuda") -> dict[str, HazardReport]:
    """Queue the reference's engine workload shapes — mixed
    read/recover/update flushes, same-stripe update chains, mixed payload
    lengths — on UniLRC(1, 4) over `Topology(4, 8)` with 64-byte blocks
    written by `TorchBackend(device)`, and analyze each without executing
    it."""
    from repro_torch.ckpt.store import BlockStore
    from repro_torch.ckpt.stripe import StripeCodec
    from repro_torch.core.codes import make_unilrc
    from repro_torch.io.backend import TorchBackend
    from repro_torch.topo import Topology

    code = make_unilrc(1, 4)
    BS = 64
    rng = np.random.default_rng(0)
    backend = TorchBackend(device)

    def fresh():
        store = BlockStore(Topology(4, 8))
        codec = StripeCodec(code, store, block_size=BS, backend=backend)
        codec.write(rng.integers(0, 256, size=4 * code.k * BS,
                                 dtype=np.uint8).tobytes())
        return store, codec.engine

    reports: dict[str, HazardReport] = {}

    store, engine = fresh()
    for sid in range(4):
        engine.submit_read(sid, 0)
    engine.submit_recover(0, 1)
    reports["reads+recover"] = analyze_flush(engine)

    store, engine = fresh()
    store.fail_node(store.node_of(1, 2))
    engine.submit_recover(1, 2)
    engine.submit_update(0, 0, bytes(BS))
    engine.submit_update(0, 1, bytes(BS))      # same stripe: second wave
    engine.submit_update(2, 3, bytes(BS))
    reports["degraded+update-chain"] = analyze_flush(engine)

    store, engine = fresh()
    for sid in range(4):
        engine.submit_update(sid, sid % code.k, bytes(BS))
    engine.submit_update(0, 2, b"\x01" * BS)
    reports["update-fanout"] = analyze_flush(engine)

    return reports


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Statically prove queued engine flushes hazard-free.")
    ap.add_argument("--out", type=pathlib.Path,
                    help="write the per-workload hazard report JSON here")
    ap.add_argument("--device", default="cuda",
                    help="device of the workloads' writes (cuda or cpu)")
    args = ap.parse_args(argv)
    reports = _workload_reports(args.device)
    ok = True
    for name, rep in reports.items():
        verdict = "OK" if rep.ok else "HAZARD"
        print(f"{verdict} {name}: {rep.ops} ops, {rep.waves} waves, "
              f"{len(rep.violations)} violations")
        for v in rep.violations:
            print(f"  {v}", file=sys.stderr)
        ok = ok and rep.ok
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"workloads": {k: r.to_dict() for k, r in reports.items()}},
            indent=2))
        print(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
