"""UniLRC core for the port: GF(2^8), the codes, recovery and decode
plans, and placement — host-side numpy copies of `repro.core`."""
from .codec import (DecodePlan, RecoveryPlan, all_recovery_plans,
                    clear_plan_caches, decode_plan, decode_plan_cached,
                    plans_for, single_recovery_plan)
from .codes import (ALL_SCHEMES, Code, cauchy_matrix, code_from_state,
                    make_alrc, make_olrc, make_ulrc, make_unilrc,
                    paper_schemes)
from .placement import (Placement, default_placement, place_ecwide,
                        place_unilrc, place_unilrc_relaxed)

__all__ = [
    "ALL_SCHEMES", "Code", "cauchy_matrix", "code_from_state", "make_alrc",
    "make_olrc", "make_ulrc", "make_unilrc", "paper_schemes",
    "DecodePlan", "RecoveryPlan", "all_recovery_plans", "clear_plan_caches",
    "decode_plan", "decode_plan_cached", "plans_for", "single_recovery_plan",
    "Placement", "default_placement", "place_ecwide", "place_unilrc",
    "place_unilrc_relaxed",
]
