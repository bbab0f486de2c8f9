"""The stripe layer of the port: the in-memory `BlockStore` and the
`StripeCodec` planner (write, read, degraded read, recovery, delta
update, rebuild)."""
from .store import BlockStore, NodeFailure, TrafficStats, store_from_state
from .stripe import (RecoveryStats, RepairReport, StripeCodec, StripeMeta)

__all__ = ["BlockStore", "NodeFailure", "TrafficStats", "store_from_state",
           "RecoveryStats", "RepairReport", "StripeCodec", "StripeMeta"]
