"""The cluster/node/link model every layer shares.

A deployment is z clusters × `nodes_per_cluster` hosts with three link
tiers (the paper's §4.2 testbed structure — Wondershaper-limited
gateways over a shared core):

  * intra-cluster — per-node NICs at `inner_gbps` (fast, parallel);
  * gateway       — each cluster's uplink/downlink at `cross_gbps`
                    (the scarce resource topology locality minimises);
  * core          — the shared spine carrying every cross-cluster byte;
    its capacity is the aggregate gateway bandwidth divided by the
    `oversubscription` factor, so `oversubscription=1` is a
    non-blocking fabric and 10x means ten gateways' worth of traffic
    squeezes through one gateway's worth of core.

`Topology` also owns the node-id arithmetic (the round-robin slot
mapping the checkpoint store has always used): node id =
cluster * nodes_per_cluster + slot, with slot wraparound so stripe-id
rotation spreads parity load across a cluster's hosts.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Topology:
    """z clusters × nodes_per_cluster hosts, with per-tier link speeds.

    The two positional fields are the historical `ClusterTopology`
    constructor (kept: every store/codec call site builds
    `Topology(num_clusters, nodes_per_cluster)`); the link fields
    default to the paper's testbed ratio (10 Gb/s inner, 1 Gb/s
    gateways, non-blocking core).
    """
    num_clusters: int
    nodes_per_cluster: int
    inner_gbps: float = 10.0
    cross_gbps: float = 1.0
    oversubscription: float = 1.0

    def __post_init__(self):
        if self.num_clusters < 1 or self.nodes_per_cluster < 1:
            raise ValueError("topology needs >= 1 cluster and node")
        if self.oversubscription < 1.0:
            raise ValueError("oversubscription factor is >= 1 "
                             "(1 = non-blocking core)")

    @property
    def num_nodes(self) -> int:
        return self.num_clusters * self.nodes_per_cluster

    @property
    def core_gbps(self) -> float:
        """Core capacity: aggregate gateway bandwidth / oversubscription."""
        return self.num_clusters * self.cross_gbps / self.oversubscription

    def node_of(self, cluster: int, slot: int) -> int:
        return cluster * self.nodes_per_cluster + slot % self.nodes_per_cluster

    def cluster_of(self, node: int) -> int:
        return node // self.nodes_per_cluster

    def with_oversubscription(self, factor: float) -> "Topology":
        """Same fabric, different core contention (benchmark sweeps)."""
        return dataclasses.replace(self, oversubscription=factor)
