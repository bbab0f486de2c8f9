"""The checkpoint layer of the port: the in-memory `BlockStore` and the
durable `DiskBlockStore`, the `StripeCodec` planner (write, read, degraded
read, recovery, delta update, rebuild), the MTTDL-driven `choose_code`,
tree serialization and the `CheckpointManager`."""
from .manager import CheckpointManager, RestoreReport
from .serialize import Manifest, deserialize_tree, serialize_tree
from .store import (BlockStore, DiskBlockStore, NodeFailure, TrafficStats,
                    store_from_state)
from .stripe import (RecoveryStats, RepairReport, StripeCodec, StripeMeta,
                     choose_code)

__all__ = ["BlockStore", "DiskBlockStore", "NodeFailure", "TrafficStats",
           "store_from_state", "RecoveryStats", "RepairReport", "StripeCodec",
           "StripeMeta", "choose_code", "CheckpointManager", "RestoreReport",
           "Manifest", "deserialize_tree", "serialize_tree"]
