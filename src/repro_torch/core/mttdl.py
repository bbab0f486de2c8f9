"""MTTDL via the paper's Markov model (§5, Fig 9); port of
`repro.core.mttdl`.

States count available nodes of a stripe: n, n-1, ..., n-f-1 where f is the
number of tolerable failures (state n-f-1 = data loss, absorbing).

Transitions:
  i -> i-1 at rate i*λ              (any of i live nodes fails)
  n-1 -> n at rate μ  = ε(N-1)B/(C·S)   (single-failure repair,
                                         bandwidth-limited)
  i -> i+1 at rate μ' = 1/T  for i < n-1 (multi-failure repair, detection
                                          time limited; prioritised)

C = C1 + δ·C2  — recovery traffic per failed block, C1 cross-cluster
blocks, C2 inner-cluster blocks, δ = cross/inner bandwidth ratio (§5).

Exact MTTDL from the expected-absorption-time linear system, solved in
rational arithmetic (magnitudes reach 1e60 years — floats underflow).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

from repro_torch.topo import NetworkModel

from .codec import plans_for
from .codes import Code
from .metrics import LocalityMetrics

HOURS_PER_YEAR = 24 * 365


@dataclasses.dataclass(frozen=True)
class MTTDLParams:
    """Defaults = paper §5: N=400 nodes, S=16TB, ε=0.1, δ=0.1, T=30min,
    B=1Gb/s, 1/λ=4yr."""
    N: int = 400
    S_TB: float = 16.0
    epsilon: float = 0.1
    delta: float = 0.1
    T_hours: float = 0.5
    B_Gbps: float = 1.0
    node_mttf_years: float = 4.0


def failure_rate_per_hour(p: MTTDLParams) -> float:
    """λ in 1/hour — per-node failure rate of the §5 chain."""
    return 1.0 / (p.node_mttf_years * HOURS_PER_YEAR)


def repair_bandwidth_TB_per_hour(p: MTTDLParams) -> float:
    """Aggregate repair bandwidth ε(N-1)B in TB/hour — the single shared
    number behind both the Markov repair rate μ and the simulator's
    bandwidth-constrained repair scheduler (the reference's
    `sim/repair.py`)."""
    return p.epsilon * (p.N - 1) * p.B_Gbps * 3600 / 8 / 1000


def repair_rates(C_blocks: float, p: MTTDLParams) -> tuple[float, float]:
    """(μ, μ') in 1/hour. C_blocks = effective recovery traffic per block
    (already δ-weighted), in units of block volumes; the node stores S of
    data so repairing a node moves C·S bytes."""
    mu = repair_bandwidth_TB_per_hour(p) / (C_blocks * p.S_TB)
    mu_prime = 1.0 / p.T_hours
    return mu, mu_prime


def markov_rates(C_blocks: float, p: MTTDLParams) -> tuple[float, float, float]:
    """(λ, μ, μ') in 1/hour — the exact transition rates of the §5 chain.

    The reference's Monte Carlo simulator (`sim/montecarlo.py`) draws its
    exponential hazards from this same function, so the memoryless
    cross-validation
    compares the two solvers on *identical* rates, not merely similar
    parameterizations."""
    mu, mu_p = repair_rates(C_blocks, p)
    return failure_rate_per_hour(p), mu, mu_p


def mttdl_years_stripe(code_n: int, f: int, C_blocks: float,
                       p: MTTDLParams = MTTDLParams()) -> float:
    """MTTDL (years) with the paper's stripe-level chain: states
    code_n .. code_n-f-1, failure rate i·λ at state i.

    f=0 (an MDS code with d=1, or any code whose single surviving-state
    chain is degenerate) collapses to E = 1/(n·λ): the first failure is
    data loss and repairs never enter."""
    return mttdl_years_from_rates(code_n, f, *markov_rates(C_blocks, p))


def mttdl_years_from_rates(code_n: int, f: int, lam_f: float, mu_f: float,
                           mu_pf: float) -> float:
    """The exact-absorption solve on explicit (λ, μ, μ') rates — the
    shared back end of the aggregate-pipe chain (`mttdl_years_stripe`)
    and the topology-aware chain (`mttdl_years_topology`), which differ
    only in where μ comes from."""
    lam = Fraction(lam_f).limit_denominator(10**15)
    mu = Fraction(mu_f).limit_denominator(10**15)
    mu_p = Fraction(mu_pf).limit_denominator(10**15)

    # States indexed by number of failed blocks j = 0..f+1 (j=f+1 absorbing).
    # E_j = expected time to absorption. E_{f+1} = 0.
    # (λ_j + μ_j) E_j = 1 + λ_j E_{j+1} + μ_j E_{j-1},  λ_j = (n-j)λ,
    # μ_0 = 0, μ_1 = μ, μ_j = μ' for j >= 2.
    f = int(f)
    lam_j = [Fraction(code_n - j) * lam for j in range(f + 1)]
    mu_j = [Fraction(0)] + [mu] + [mu_p] * max(0, f - 1)

    # Solve tridiagonal system exactly by forward elimination:
    # express E_j = a_j + b_j * E_{j+1}.
    a = [Fraction(0)] * (f + 1)
    b = [Fraction(0)] * (f + 1)
    # j = 0: λ_0 E_0 = 1 + λ_0 E_1  =>  E_0 = 1/λ_0 + E_1
    a[0] = 1 / lam_j[0]
    b[0] = Fraction(1)
    for j in range(1, f + 1):
        # (λ_j+μ_j) E_j = 1 + λ_j E_{j+1} + μ_j (a_{j-1} + b_{j-1} E_j)
        denom = lam_j[j] + mu_j[j] - mu_j[j] * b[j - 1]
        a[j] = (1 + mu_j[j] * a[j - 1]) / denom
        b[j] = lam_j[j] / denom
    # E_{f+1} = 0  => back-substitute
    E = Fraction(0)
    for j in range(f, -1, -1):
        E = a[j] + b[j] * E
    return float(E / HOURS_PER_YEAR)


def topology_repair_hours(code: Code, placement, topo, p: MTTDLParams,
                          *, block: int | None = None) -> float:
    """Hours to repair one node's worth of data (S TB) through the
    topology's per-link bottlenecks — the generalisation of 1/μ = C·S /
    ε(N−1)B that the aggregate pipe cannot express.

    The per-block link schedule (gateway aggregation included, via the
    network model's validity check) is scaled to S TB and timed by the
    slowest link: survivor-cluster uplinks, the oversubscribed core,
    the home cluster's downlink, or node-NIC ingest. `block=None`
    averages over all n blocks (a failed node holds a uniform mix under
    the slot rotation); pass a block id for that block's repair alone."""
    net = NetworkModel.from_repair_pipe(topo, repair_bandwidth_TB_per_hour(p),
                                        p.delta)
    plans = plans_for(code)
    targets = range(code.n) if block is None else [block]
    hours = []
    for b in targets:
        sched = net.recovery_schedule(placement.assignment, b,
                                      plans[b].sources, plan=plans[b],
                                      block_bytes=p.S_TB)
        hours.append(net.transfer_time(sched))
    return float(sum(hours) / len(hours))


def topology_repair_rates(code: Code, placement, topo,
                          p: MTTDLParams) -> tuple[float, float]:
    """(μ, μ') with μ from the topology-aware bottleneck transfer time.
    μ' stays detection-limited (1/T), as in the chain."""
    return 1.0 / topology_repair_hours(code, placement, topo, p), \
        1.0 / p.T_hours


def mttdl_years_topology(code: Code, placement, topo,
                         p: MTTDLParams = MTTDLParams()) -> float:
    """End-to-end MTTDL with the repair rate derived from the topology's
    link model instead of the aggregate ε(N−1)B pipe. With a
    non-blocking core (oversubscription 1) and the default δ link
    ratio this is at least as fast as the pipe (links run in
    parallel); oversubscribing the core slows μ and drops MTTDL."""
    f = tolerable_failures(code)
    mu, mu_p = topology_repair_rates(code, placement, topo, p)
    return mttdl_years_from_rates(code.n, f, failure_rate_per_hour(p),
                                  mu, mu_p)


def effective_recovery_traffic(m: LocalityMetrics, delta: float) -> float:
    """C = C1 + δ·C2 (paper §5): C1 = cross-cluster blocks (CARC),
    C2 = inner-cluster blocks (ARC − CARC)."""
    c1 = m.CARC
    c2 = m.ARC - m.CARC
    return c1 + delta * c2


def code_mttdl_years(code: Code, metrics: LocalityMetrics,
                     p: MTTDLParams = MTTDLParams()) -> float:
    """End-to-end: code + placement metrics -> MTTDL in years."""
    f = tolerable_failures(code)
    C = effective_recovery_traffic(metrics, p.delta)
    return mttdl_years_stripe(code.n, f, C, p)


def tolerable_failures(code: Code) -> int:
    """f = d - 1 (any f block failures recoverable)."""
    d = code.meta.get("d")
    if d is None:
        g = code.meta.get("g", code.n - code.k)
        d = g + 2
    return int(d) - 1
