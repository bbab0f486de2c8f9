"""UniLRC core for the port: GF(2^8), the codes, recovery and decode
plans, placement, the locality metrics and the MTTDL model — host-side
numpy copies of `repro.core`."""
from .codec import (DecodePlan, RecoveryPlan, all_recovery_plans,
                    cached_decode_plans, clear_plan_caches, decode_plan,
                    decode_plan_cached, plans_for, single_recovery_plan,
                    verify_erasure_tolerance)
from .codes import (ALL_SCHEMES, Code, cauchy_matrix, code_from_state,
                    make_alrc, make_olrc, make_rs, make_ulrc, make_unilrc,
                    paper_schemes)
from .metrics import (LocalityMetrics, effective_block_traffic,
                      locality_metrics, per_block_repair_traffic,
                      recovery_locality)
from .mttdl import (MTTDLParams, code_mttdl_years, effective_recovery_traffic,
                    failure_rate_per_hour, markov_rates,
                    mttdl_years_from_rates, mttdl_years_stripe,
                    mttdl_years_topology, repair_bandwidth_TB_per_hour,
                    repair_rates, tolerable_failures, topology_repair_hours,
                    topology_repair_rates)
from .placement import (Placement, default_placement, place_ecwide,
                        place_unilrc, place_unilrc_relaxed)

__all__ = [
    "ALL_SCHEMES", "Code", "cauchy_matrix", "code_from_state", "make_alrc",
    "make_olrc", "make_rs", "make_ulrc", "make_unilrc", "paper_schemes",
    "DecodePlan", "RecoveryPlan", "all_recovery_plans",
    "cached_decode_plans", "clear_plan_caches", "decode_plan",
    "decode_plan_cached", "plans_for", "single_recovery_plan",
    "verify_erasure_tolerance",
    "LocalityMetrics", "effective_block_traffic", "locality_metrics",
    "per_block_repair_traffic", "recovery_locality", "MTTDLParams",
    "code_mttdl_years", "effective_recovery_traffic", "failure_rate_per_hour",
    "markov_rates", "mttdl_years_from_rates", "mttdl_years_stripe",
    "mttdl_years_topology", "repair_bandwidth_TB_per_hour",
    "repair_rates", "topology_repair_hours", "topology_repair_rates",
    "tolerable_failures",
    "Placement", "default_placement", "place_ecwide", "place_unilrc",
    "place_unilrc_relaxed",
]
