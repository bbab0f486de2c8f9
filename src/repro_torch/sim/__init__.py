"""Event-driven failure/repair simulation (CR-SIM/PR-SIM lineage), the
port's copy of `repro.sim`.

The Markov MTTDL model in `core.mttdl` assumes exponential, independent
failures and uncontended repairs; this package stresses exactly those
assumptions with Monte Carlo simulation and cross-validates against the
closed form where the assumptions hold.

Module map
----------
events.py
    The discrete-event core: `Event`, `EventQueue` (binary heap with
    lazy cancellation, deterministic same-time ordering), `Simulator`
    (handler registration, relative scheduling, horizon/budget runs).
failures.py
    Lifetime distributions `Exponential` / `Weibull` (inverse-CDF, one
    vectorized torch draw on the device for all trial × node initial
    lifetimes via `sample_lifetimes`), and `FailureModel` bundling the
    node hazard with correlated cluster-loss arrivals.
repair.py
    `RepairScheduler`: repair charged through `repro_torch.topo.NetworkModel`
    in the Markov chain's ε(N-1)B units. By default the chain's
    serialized pipe (same numbers as μ — see `node_repair_hours`);
    with an explicit `Topology` it schedules per link — survivor
    uplinks, the oversubscribed core, downlink and NIC ingest — so
    correlated cluster loss contends on surviving gateways. Damaged
    pairs are grouped by recovery plan (a single-failure job == one
    batched kernel launch; multi-erasure jobs are pattern-grouped by
    the codec engine — one launch per distinct live erasure pattern),
    multi-failure stripes prioritised at μ' = 1/T (topology mode:
    max(T, transfer)). Data-path mode drives real bytes through the
    request front-end and folds its kernel-launch, plan-group, and
    multi-erasure deltas into the `RepairLedger`.
montecarlo.py
    Drivers: `simulate_stripe_mttdl` (the §5 chain event-by-event, for
    cross-validation against `mttdl_years_stripe`) and `run_campaign`
    (`SimConfig` -> `CampaignReport`: data-loss probability, MTTDL
    estimate, degraded-read fraction, cross-cluster repair traffic for
    a full simulated deployment). Both run on CUDA unless the caller
    asks for the CPU (`device=` / `SimConfig.device`); without a card
    the default raises. In data-path mode the repairs launch the coding
    kernels on that device through `TorchBackend`.

Typical campaign::

    from repro_torch.core import make_unilrc, MTTDLParams
    from repro_torch.sim import SimConfig, run_campaign, FailureModel, Weibull

    code = make_unilrc(alpha=1, z=6)
    cfg = SimConfig(code=code, params=MTTDLParams(node_mttf_years=0.5),
                    n_stripes=8, trials=50, seed=7,
                    failure_model=FailureModel(
                        node=Weibull(shape=0.7, scale=4000.0),
                        cluster_loss_mean_hours=2000.0),
                    device="cuda")
    report = run_campaign(cfg)
    print(report.mttdl_years, report.cross_traffic_fraction)
"""
from .events import Event, EventQueue, Simulator
from .failures import (Exponential, FailureModel, Hazard, Weibull,
                       exponential_from_mttf_years, sample_lifetimes)
from .montecarlo import (CampaignReport, DssTrial, MCEstimate, SimConfig,
                         TrialResult, markov_mttdl_years, run_campaign,
                         simulate_stripe_mttdl)
from .repair import (RepairLedger, RepairScheduler, node_repair_hours)

__all__ = [
    "Event", "EventQueue", "Simulator",
    "Exponential", "FailureModel", "Hazard", "Weibull",
    "exponential_from_mttf_years", "sample_lifetimes",
    "CampaignReport", "DssTrial", "MCEstimate", "SimConfig", "TrialResult",
    "markov_mttdl_years", "run_campaign", "simulate_stripe_mttdl",
    "RepairLedger", "RepairScheduler", "node_repair_hours",
]
