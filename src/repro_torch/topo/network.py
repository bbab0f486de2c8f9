"""Plan-on-topology arithmetic the byte path needs.

The slice of `repro.topo.network` that the engine and the placement use:
whether a plain-XOR gateway may pre-fold a plan (`plan_is_xor_linear`)
and how many block transfers cross a gateway (`cross_cluster_blocks`).
The bandwidth model, link schedules and reservations wait for the
simulator's slice of the port.

Plans are duck-typed (`.coeffs` for a RecoveryPlan, `.erased` + `.M`
for a DecodePlan) so this module sits below `repro_torch.core`.
"""
from __future__ import annotations

import numpy as np


def plan_is_xor_linear(plan) -> bool:
    """True when a plain-XOR gateway can pre-fold the plan's remote
    contribution: every GF coefficient is 1 and the plan produces a
    single output block. RecoveryPlans expose `.coeffs`; DecodePlans
    qualify only with one erased target and a 0/1 coefficient row."""
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
