"""Symbolic code verifier: certify paper invariants over GF(2^8) algebra
(the port's copy of `repro.analysis.verify`).

Every guarantee the engine's tests exercise *dynamically* (by pushing
bytes through kernels) is re-established here *statically*, on the
code's coefficient matrices alone — no kernel launch, no byte buffers:

  * generator/check consistency — H @ G == 0 exactly (algebraic);
  * local MDS — every local group with an in-group check recovers any
    single member from in-group sources only, and the minimal recovery
    plan provably inverts (sum_j c_j G[s_j] == G[target]);
  * XOR locality — local checks carry weight-1 coefficients and every
    block's minimal plan is XOR-only (UniLRC Property 2, the paper's
    fix for limitation #3);
  * optimal distance — the claimed d equals the unified-locality
    optimal-LRC bound  d = n − k − ⌈(k+g)/r⌉ + 2  and every tested
    (d−1)-erasure pattern is correctable, via the classical criterion
    rank(H[:, E]) == |E| (exhaustive when the pattern space fits a
    budget, a structured + seeded-random battery otherwise — the method
    is recorded in the claim);
  * decode-plan inversion — every cached `DecodePlan` (and a battery of
    fresh ones: all singles, in-group pairs, full-group losses, random
    multi-erasures) satisfies  M @ G[sources] == G[erased]  symbolically;
  * placement topology — groups map onto disjoint cluster sets of the
    declared width t, and every single-cluster wipe-out stays a
    correctable erasure pattern.

`certify()` returns a `Certificate` (analysis/certificate.py);
`certify_paper_grid()` sweeps the paper's (α, z) schemes × placement
width t. CLI:

    python -m repro_torch.analysis.verify --grid --out certificate.json

It writes nothing but `--out`.

The kernel-launch delta observed while certifying is recorded in each
certificate (and must be zero — `check_regression.py --analysis-cert`
gates on it).
"""
from __future__ import annotations

import argparse
import itertools
import math
import pathlib
import sys
from collections.abc import Iterable, Sequence

import numpy as np

from repro_torch.core.codec import (DecodePlan, cached_decode_plans,
                                    decode_plan_cached, plans_for)
from repro_torch.core.codes import (ALL_SCHEMES, Code, make_unilrc,
                                    paper_schemes)
from repro_torch.core.gf import gf_matmul, gf_rank
from repro_torch.core.placement import (Placement, default_placement,
                                        place_unilrc_relaxed)

from .certificate import Certificate, Claim, dump_certificates

DEFAULT_TRIALS = 400
DEFAULT_EXHAUSTIVE_BUDGET = 20_000


def erasure_correctable(code: Code, pattern: Sequence[int]) -> bool:
    """Classical criterion: erasures E are uniquely decodable iff the
    columns of the parity-check matrix restricted to E are independent."""
    cols = list(pattern)
    if not cols:
        return True
    if len(cols) > code.n - code.k:
        return False
    return gf_rank(code.H[:, cols]) == len(cols)


def optimal_lrc_distance(code: Code) -> int | None:
    """The unified-locality optimal-LRC bound d = n − k − ⌈(k+g)/r⌉ + 2.

    `r` is the recovery locality and k+g the symbols covered by local
    groups (all-symbol locality: UniLRC's groups span data AND global
    parities). Returns None when the code does not declare r/g."""
    r = code.meta.get("r")
    g = code.meta.get("g")
    if r is None or g is None:
        return None
    return code.n - code.k - math.ceil((code.k + g) / r) + 2


def plan_inverts(code: Code, plan: DecodePlan) -> bool:
    """Symbolic inversion check:  M @ G[sources] == G[erased]  over
    GF(2^8). Both sides are (|erased|, k) coefficient matrices — if they
    agree, the plan reproduces the erased symbols for EVERY payload, so
    no byte-level test is needed."""
    if not plan.erased:
        return True
    src_rows = code.G[list(plan.sources)]
    return bool(np.array_equal(gf_matmul(plan.M, src_rows),
                               code.G[list(plan.erased)]))


def _in_group_checks(code: Code, group: Sequence[int]) -> list[np.ndarray]:
    gset = set(group)
    return [h for h in code.checks
            if set(np.flatnonzero(h).tolist()) <= gset
            and np.any(h != 0)]


# ---------------------------------------------------------------------------
# Individual claim verifiers
# ---------------------------------------------------------------------------

def verify_generator_checks(code: Code) -> Claim:
    """H @ G == 0 and every declared check annihilates the generator."""
    hg_zero = not gf_matmul(code.H, code.G).any()
    checks_zero = not gf_matmul(code.checks, code.G).any()
    ok = hg_zero and checks_zero
    return Claim(
        name="generator_check_consistency", ok=ok, method="algebraic",
        detail=("H@G == 0 and checks@G == 0" if ok else
                f"H@G zero: {hg_zero}, checks@G zero: {checks_zero}"),
        data={"num_checks": int(code.checks.shape[0])})


def verify_local_mds(code: Code) -> Claim:
    """Every local group with an in-group check is single-erasure MDS:
    each member is recoverable from in-group survivors, and the minimal
    recovery plan provably inverts. For UniLRC every group must qualify
    (unified locality); other families record how many do."""
    plans = plans_for(code)
    strict = code.meta.get("family") == "unilrc"
    groups_with_check = 0
    bad: list[str] = []
    for gi, grp in enumerate(code.groups):
        checks = _in_group_checks(code, grp)
        if not checks:
            if strict:
                bad.append(f"group {gi} has no in-group check")
            continue
        groups_with_check += 1
        gset = set(grp)
        for h in checks:
            if any(h[b] == 0 for b in grp):
                bad.append(f"group {gi}: check misses a member")
        for b in grp:
            plan = plans[b]
            if not set(plan.sources) <= gset - {b}:
                bad.append(f"block {b}: minimal plan leaves group {gi}")
                continue
            lhs = np.zeros(code.k, dtype=np.uint8)
            for s, c in zip(plan.sources, plan.coeffs):
                lhs ^= gf_matmul(np.array([[c]], dtype=np.uint8),
                                 code.G[s][None, :])[0]
            if not np.array_equal(lhs, code.G[b]):
                bad.append(f"block {b}: minimal plan does not invert")
    ok = not bad
    return Claim(
        name="local_groups_mds", ok=ok, method="algebraic",
        detail=("every group single-erasure MDS with in-group recovery"
                if ok else "; ".join(bad[:4])),
        data={"groups": len(code.groups),
              "groups_with_local_check": groups_with_check,
              "violations": len(bad)})


def verify_xor_locality(code: Code) -> Claim:
    """Weight-1 local coding (paper limitation #3, fixed by UniLRC):
    every in-group check row is 0/1-valued and every block's minimal
    recovery plan is a pure XOR. Strict for UniLRC; other families
    record their XOR-recoverable block count."""
    plans = plans_for(code)
    strict = code.meta.get("family") == "unilrc"
    xor_blocks = sum(1 for p in plans if p.xor_only)
    nonbinary_checks = 0
    for grp in code.groups:
        for h in _in_group_checks(code, grp):
            if np.any((h != 0) & (h != 1)):
                nonbinary_checks += 1
    ok = (nonbinary_checks == 0
          and (not strict or xor_blocks == code.n))
    return Claim(
        name="xor_local_parities", ok=ok, method="algebraic",
        detail=(f"{xor_blocks}/{code.n} blocks XOR-recoverable, "
                f"{nonbinary_checks} non-binary local checks"),
        data={"xor_recoverable_blocks": xor_blocks,
              "nonbinary_local_checks": nonbinary_checks})


def verify_distance(code: Code, *, trials: int = DEFAULT_TRIALS,
                    seed: int = 0,
                    exhaustive_budget: int = DEFAULT_EXHAUSTIVE_BUDGET
                    ) -> Claim:
    """d meets the claimed fault tolerance: every tested (d−1)-erasure
    pattern is correctable (rank criterion). Exhaustive when
    C(n, d−1) <= exhaustive_budget; otherwise structured families (every
    full group, two-group splits, parity-heavy sets) plus a seeded
    random battery. For UniLRC the claimed d must also EQUAL the
    unified-locality optimal bound n − k − ⌈(k+g)/r⌉ + 2."""
    d = int(code.meta.get("d", 0))
    if d <= 0:
        return Claim(name="distance_meets_optimal_bound", ok=False,
                     method="none", detail="code declares no distance")
    e = d - 1
    n = code.n
    bound = optimal_lrc_distance(code)
    if code.meta.get("family") == "unilrc" and bound is not None and d != bound:
        return Claim(
            name="distance_meets_optimal_bound", ok=False, method="algebraic",
            detail=f"claimed d={d} != optimal-LRC bound {bound}",
            data={"claimed_d": d, "optimal_bound": bound})

    patterns: Iterable[tuple[int, ...]]
    total = math.comb(n, e)
    if total <= exhaustive_budget:
        method = f"exhaustive(C({n},{e})={total})"
        patterns = itertools.combinations(range(n), e)
    else:
        battery: list[tuple[int, ...]] = []
        groups = [list(g) for g in code.groups]
        for grp in groups:                      # full-group / cluster loss
            if len(grp) <= e:
                extra = [b for b in range(n) if b not in grp][:e - len(grp)]
                battery.append(tuple(grp + extra))
        for gi, gj in itertools.combinations(range(len(groups)), 2):
            for take in {1, e // 2, e - 1}:     # two-group splits
                if 1 <= take <= len(groups[gi]) and e - take <= len(groups[gj]):
                    battery.append(tuple(groups[gi][:take]
                                         + groups[gj][:e - take]))
        parities = [b for b in range(n) if code.block_type[b] != 'd']
        if len(parities) >= e:                  # parity-heavy set
            battery.append(tuple(parities[:e]))
        rng = np.random.default_rng(seed)
        for _ in range(trials):
            battery.append(tuple(sorted(
                int(b) for b in rng.choice(n, size=e, replace=False))))
        method = (f"sampled(structured={len(battery) - trials},"
                  f"random={trials},seed={seed})")
        patterns = battery

    checked = 0
    for pat in patterns:
        checked += 1
        if not erasure_correctable(code, pat):
            return Claim(
                name="distance_meets_optimal_bound", ok=False, method=method,
                detail=f"uncorrectable ({e})-erasure pattern found",
                data={"claimed_d": d, "optimal_bound": bound,
                      "counterexample": list(pat)})
    return Claim(
        name="distance_meets_optimal_bound", ok=True, method=method,
        detail=f"all {checked} tested ({e})-erasure patterns correctable; "
               f"claimed d={d}" + (f" == optimal bound" if d == bound else ""),
        data={"claimed_d": d, "optimal_bound": bound,
              "patterns_checked": checked})


def _decode_battery(code: Code, *, trials: int, seed: int,
                    pairs_per_group: int = 12) -> list[tuple[int, ...]]:
    """Deterministic battery of erasure patterns for plan-inversion
    checks: all singles, a capped set of in-group pairs, every
    full-group (cluster) loss, and seeded random multi-erasures up to
    the code's erasure budget."""
    pats: list[tuple[int, ...]] = [(b,) for b in range(code.n)]
    for grp in code.groups:
        pairs = list(itertools.combinations(grp, 2))[:pairs_per_group]
        pats += [tuple(sorted(p)) for p in pairs]
        if len(grp) <= code.n - code.k:
            pats.append(tuple(sorted(grp)))
    rng = np.random.default_rng(seed)
    max_e = max(2, min(code.n - code.k, int(code.meta.get("d", 3)) - 1))
    for _ in range(trials):
        e = int(rng.integers(2, max_e + 1))
        pats.append(tuple(sorted(
            int(b) for b in rng.choice(code.n, size=e, replace=False))))
    return pats


def verify_decode_plans(code: Code, *, trials: int = DEFAULT_TRIALS,
                        seed: int = 0) -> Claim:
    """Every decode plan in the battery — and every plan already sitting
    in the memoized cache — symbolically inverts its erasure pattern:
    M @ G[sources] == G[erased]. Patterns beyond tolerance must be
    *rejected* (ValueError), never mis-decoded."""
    checked = rejected = 0
    for pat in _decode_battery(code, trials=trials, seed=seed):
        try:
            plan = decode_plan_cached(code, pat)
        except ValueError:
            rejected += 1
            if erasure_correctable(code, pat):
                return Claim(
                    name="decode_plans_invert", ok=False,
                    method="algebraic",
                    detail="correctable pattern rejected by planner",
                    data={"pattern": list(pat)})
            continue
        checked += 1
        if not plan_inverts(code, plan):
            return Claim(
                name="decode_plans_invert", ok=False, method="algebraic",
                detail="plan does not invert its pattern",
                data={"pattern": list(pat)})
    cached = cached_decode_plans(code)
    for plan in cached:
        if not plan_inverts(code, plan):
            return Claim(
                name="decode_plans_invert", ok=False, method="algebraic",
                detail="CACHED plan does not invert its pattern",
                data={"pattern": list(plan.erased)})
    return Claim(
        name="decode_plans_invert", ok=True,
        method=f"algebraic(battery={checked},cached={len(cached)},"
               f"seed={seed})",
        detail=f"{checked} battery plans + {len(cached)} cached plans "
               f"invert; {rejected} beyond-tolerance patterns rejected",
        data={"battery_plans": checked, "cached_plans": len(cached),
              "rejected_patterns": rejected})


def verify_placement(code: Code, placement: Placement, *,
                     t: int | None = None,
                     nodes_per_cluster: int | None = None) -> Claim:
    """Topology invariant (paper §3.1/§3.3): local groups map onto
    DISJOINT cluster sets of width exactly t (t=1 is the native
    one-group-one-cluster placement), and wiping any single cluster
    leaves a correctable erasure pattern. With `nodes_per_cluster`,
    also checks each cluster holds at most that many stripe blocks
    (the slot invariant StripeCodec enforces at runtime)."""
    assign = placement.assignment
    bad: list[str] = []
    seen_clusters: set[int] = set()
    widths: set[int] = set()
    for gi, grp in enumerate(code.groups):
        clusters = {assign[b] for b in grp}
        widths.add(len(clusters))
        if t is not None and len(clusters) != t:
            bad.append(f"group {gi} spans {len(clusters)} clusters != t={t}")
        if clusters & seen_clusters:
            bad.append(f"group {gi} shares a cluster with another group")
        seen_clusters |= clusters
    blocks_by_cluster = placement.blocks_by_cluster()
    for c, blocks in enumerate(blocks_by_cluster):
        if not blocks:
            continue
        if nodes_per_cluster is not None and len(blocks) > nodes_per_cluster:
            bad.append(f"cluster {c} holds {len(blocks)} blocks "
                       f"> {nodes_per_cluster} nodes")
        if not erasure_correctable(code, blocks):
            bad.append(f"cluster {c} loss is uncorrectable")
    ok = not bad
    return Claim(
        name="placement_topology", ok=ok, method="algebraic",
        detail=("groups on disjoint clusters, every cluster loss "
                "correctable" if ok else "; ".join(bad[:4])),
        data={"clusters": placement.num_clusters,
              "group_widths": sorted(widths),
              "violations": len(bad)})


# ---------------------------------------------------------------------------
# Certification entry points
# ---------------------------------------------------------------------------

def _launch_total() -> int:
    """Total kernel launches so far — 0 when the kernel layer (and with
    it torch) was never imported, which is itself the strongest evidence
    that certification is launch-free."""
    mod = sys.modules.get("repro_torch.kernels.ops")
    if mod is None:
        return 0
    return int(sum(mod.KERNEL_LAUNCHES.values()))


def certify(code: Code, placement: Placement | None = None, *,
            t: int | None = None, trials: int = DEFAULT_TRIALS,
            seed: int = 0,
            exhaustive_budget: int = DEFAULT_EXHAUSTIVE_BUDGET,
            nodes_per_cluster: int | None = None) -> Certificate:
    """Run every pillar-1 claim for one (code, placement) pair.

    Pure host-side GF algebra: the certificate records the kernel-launch
    delta observed while certifying, which must be zero."""
    placement = placement or default_placement(code)
    if t is None and placement.name == "one-group-one-cluster":
        t = 1
    launches0 = _launch_total()
    claims = (
        verify_generator_checks(code),
        verify_local_mds(code),
        verify_xor_locality(code),
        verify_distance(code, trials=trials, seed=seed,
                        exhaustive_budget=exhaustive_budget),
        verify_decode_plans(code, trials=trials, seed=seed),
        verify_placement(code, placement, t=t,
                         nodes_per_cluster=nodes_per_cluster),
    )
    params = {"n": code.n, "k": code.k, **{
        key: code.meta[key] for key in ("family", "alpha", "z", "r", "d", "g")
        if key in code.meta}}
    if t is not None:
        params["t"] = t
    return Certificate(
        code_name=code.name, placement_name=placement.name,
        params=params, claims=claims,
        kernel_launches=_launch_total() - launches0)


def certify_paper_grid(*, trials: int = DEFAULT_TRIALS, seed: int = 0,
                       exhaustive_budget: int = DEFAULT_EXHAUSTIVE_BUDGET,
                       ts: Sequence[int] = (1, 2)) -> list[Certificate]:
    """Certify every paper-grid UniLRC (α, z) under each placement width
    t: t=1 native one-group-one-cluster, t>=2 the §3.3 relaxed split."""
    certs: list[Certificate] = []
    for scheme in ALL_SCHEMES:
        uni = paper_schemes(scheme)["UniLRC"]
        code = make_unilrc(uni.meta["alpha"], uni.meta["z"])
        for t in ts:
            placement = (default_placement(code) if t == 1 else
                         place_unilrc_relaxed(code, t))
            certs.append(certify(code, placement, t=t, trials=trials,
                                 seed=seed,
                                 exhaustive_budget=exhaustive_budget))
    return certs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Symbolically certify code invariants (no kernels).")
    ap.add_argument("--grid", action="store_true",
                    help="certify the paper (alpha, z) x t grid")
    ap.add_argument("--alpha", type=int, help="certify one UniLRC(alpha, z)")
    ap.add_argument("--z", type=int)
    ap.add_argument("--t", type=int, default=1, help="placement width")
    ap.add_argument("--trials", type=int, default=DEFAULT_TRIALS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exhaustive-budget", type=int,
                    default=DEFAULT_EXHAUSTIVE_BUDGET)
    ap.add_argument("--out", type=pathlib.Path,
                    help="write the certificate batch JSON here")
    args = ap.parse_args(argv)

    if args.grid:
        certs = certify_paper_grid(trials=args.trials, seed=args.seed,
                                   exhaustive_budget=args.exhaustive_budget)
    elif args.alpha is not None and args.z is not None:
        code = make_unilrc(args.alpha, args.z)
        placement = (default_placement(code) if args.t == 1 else
                     place_unilrc_relaxed(code, args.t))
        certs = [certify(code, placement, t=args.t, trials=args.trials,
                         seed=args.seed,
                         exhaustive_budget=args.exhaustive_budget)]
    else:
        ap.error("pass --grid, or --alpha and --z")
        return 2
    for cert in certs:
        print(cert.summary())
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
