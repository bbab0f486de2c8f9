"""Cluster topology for the port: the z clusters × nodes model, the
bandwidth-annotated `NetworkModel` with its per-link schedules, and the
link reservation ledger (copies of `repro.topo`)."""
from .network import (RESERVATION_EPS, LinkReservations, LinkSchedule,
                      NetworkModel, cross_cluster_blocks, flow_rates,
                      merge_reservation, plan_is_xor_linear,
                      release_reservation, reservation_fits)
from .topology import Topology

__all__ = ["Topology", "NetworkModel", "LinkSchedule", "LinkReservations",
           "cross_cluster_blocks", "plan_is_xor_linear", "RESERVATION_EPS",
           "flow_rates", "reservation_fits", "merge_reservation",
           "release_reservation"]
