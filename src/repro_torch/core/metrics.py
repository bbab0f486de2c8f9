"""Locality metrics (paper Table 3): ADRC, CDRC, ARC, CARC, LBNR
(port of `repro.core.metrics`).

cost(b_i)   = number of blocks read to reconstruct block i
cost^c(b_i) = number of those blocks crossing a cluster gateway
LBNR        = max_c(blocks of a normal read served by cluster c)
              / avg_c(blocks served)           (optimal = 1.0)

Cross-cluster costs route through `repro_torch.topo.NetworkModel`, which
applies gateway XOR aggregation exactly when the plan admits it
(`plan_is_xor_linear`): an XOR-only plan whose remote sources share a
cluster ships ONE pre-folded block per remote cluster — the §3.3
reading under which the relaxed "one group, t clusters" placement
costs t−1 cross-cluster blocks per recovery. Cauchy-coefficient plans
(e.g. global-parity repair) and multi-target decodes are charged per
remote block, because a plain-XOR gateway cannot fold them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.topo import NetworkModel, Topology

from .codec import plans_for
from .codes import Code
from .placement import Placement


def _network_for(placement: Placement,
                 network: NetworkModel | None) -> NetworkModel:
    """Counting-only NetworkModel on the placement's cluster count (link
    speeds are irrelevant to block counts)."""
    if network is not None:
        return network
    return NetworkModel.from_topology(
        Topology(placement.num_clusters, 1))


@dataclasses.dataclass(frozen=True)
class LocalityMetrics:
    code: str
    placement: str
    ADRC: float   # avg degraded read cost (data blocks only)
    CDRC: float   # cross-cluster ADRC (gateway-aggregated where valid)
    ARC: float    # avg recovery cost (all blocks) == recovery locality r̄
    CARC: float   # cross-cluster ARC (gateway-aggregated where valid)
    LBNR: float   # load balance ratio of normal read
    xor_fraction: float  # fraction of single-block recoveries that are XOR-only

    def row(self) -> dict:
        return dataclasses.asdict(self)


def locality_metrics(code: Code, placement: Placement, *,
                     network: NetworkModel | None = None
                     ) -> LocalityMetrics:
    plans = plans_for(code)
    k = code.k
    traffic = per_block_repair_traffic(code, placement, network=network)
    costs = traffic[:, 0].astype(float)
    cross = traffic[:, 1].astype(float)

    adrc = float(costs[:k].mean())
    cdrc = float(cross[:k].mean())
    arc = float(costs.mean())
    carc = float(cross.mean())

    # Normal read: read all k data blocks; per-cluster service counts.
    per_cluster = np.zeros(placement.num_clusters, dtype=float)
    for i in range(k):
        per_cluster[placement.assignment[i]] += 1
    nonzero = per_cluster[per_cluster > 0]
    lbnr = float(nonzero.max() / nonzero.mean())

    xor_frac = float(np.mean([p.xor_only for p in plans]))
    return LocalityMetrics(code.name, placement.name, adrc, cdrc, arc, carc,
                           lbnr, xor_frac)


def recovery_locality(code: Code) -> float:
    """r̄ — average blocks accessed for single-block recovery (§2.3.1)."""
    plans = plans_for(code)
    return float(np.mean([p.cost for p in plans]))


def per_block_repair_traffic(code: Code, placement: Placement, *,
                             network: NetworkModel | None = None
                             ) -> np.ndarray:
    """(n, 2) int array: [total blocks read, cross-cluster block
    transfers] for the minimal single-failure repair of each block under
    `placement`, through the network model's aggregation-validity check.

    This is the per-block decomposition of ARC/CARC that a failure
    simulator's repair scheduler charges against its bandwidth budget;
    row-averaging column 0 gives ARC and column 1 gives CARC exactly."""
    net = _network_for(placement, network)
    plans = plans_for(code)
    out = np.zeros((code.n, 2), dtype=np.int64)
    for i, p in enumerate(plans):
        total, cross = net.recovery_blocks(placement.assignment, p.target,
                                           p.sources, plan=p)
        out[i, 0] = total
        out[i, 1] = cross
    return out


def effective_block_traffic(code: Code, placement: Placement,
                            delta: float) -> np.ndarray:
    """(n,) float array: δ-weighted recovery traffic C_i = cross_i +
    δ·inner_i per block — the per-block analogue of
    `mttdl.effective_recovery_traffic`, in block volumes. Inner here is
    every read that stays behind a gateway, including the remote-side
    reads behind a pre-fold."""
    t = per_block_repair_traffic(code, placement)
    cross = t[:, 1].astype(float)
    inner = (t[:, 0] - t[:, 1]).astype(float)
    return cross + delta * inner
