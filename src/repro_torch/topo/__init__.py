"""Cluster topology for the port: the z clusters × nodes model and the
plan-on-topology helpers the byte path needs (copies of `repro.topo`)."""
from .network import cross_cluster_blocks, plan_is_xor_linear
from .topology import Topology

__all__ = ["Topology", "cross_cluster_blocks", "plan_is_xor_linear"]
