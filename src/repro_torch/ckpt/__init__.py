"""The checkpoint layer of the port: the in-memory `BlockStore`, the
`StripeCodec` planner (write, read, degraded read, recovery, delta
update, rebuild), tree serialization and the `CheckpointManager`."""
from .manager import CheckpointManager, RestoreReport
from .serialize import Manifest, deserialize_tree, serialize_tree
from .store import BlockStore, NodeFailure, TrafficStats, store_from_state
from .stripe import (RecoveryStats, RepairReport, StripeCodec, StripeMeta)

__all__ = ["BlockStore", "NodeFailure", "TrafficStats", "store_from_state",
           "RecoveryStats", "RepairReport", "StripeCodec", "StripeMeta",
           "CheckpointManager", "RestoreReport", "Manifest",
           "deserialize_tree", "serialize_tree"]
