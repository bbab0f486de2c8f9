"""Static cost of a traced step (port of `repro.launch.hlo_cost`).

The reference parses XLA's HLO module and multiplies each computation's
cost by its loop trip count, because XLA's `cost_analysis()` counts a
while-loop body once and every layer stack there is a `lax.scan`. The
port's step is a Python loop over layers (and microbatches, and attention
chunks): the trace (`launch.hlo.TraceRecorder`) holds every iteration's
ops, so its sums need no trip count, and the port has no counterpart of
the reference's `parse_module` / `_trip_count`.

  flops            the FLOPs of every op of the trace on this device's
                   shards (PyTorch's formulas, the flash operator's
                   `bound_flops`): per device, as the reference's are;
                   `FlopCounterMode` over DTensor ops counts global FLOPs
  bytes            an HBM-traffic proxy: input + output bytes of every op
                   that moves data (views and allocations are free)
  collectives      per kind: result bytes, counts, the largest group, and
                   the bytes of collectives that span pods
"""
from __future__ import annotations

import dataclasses

from .hlo import Trace, collective_stats


@dataclasses.dataclass
class StaticCost:
    flops: float
    bytes: float
    coll_bytes_by_op: dict
    coll_count_by_op: dict
    coll_group_size: dict
    coll_cross_pod: float

    def to_json(self):
        return dataclasses.asdict(self)


def analyze(trace: Trace, *, pod_size: int = 256) -> StaticCost:
    """The trace's per-device cost (`pod_size` was fixed when it was
    recorded)."""
    cs = collective_stats(trace, pod_size)
    return StaticCost(
        flops=float(sum(r.flops for r in trace.ops)),
        bytes=float(sum(r.bytes for r in trace.ops)),
        coll_bytes_by_op=cs.bytes_by_op, coll_count_by_op=cs.count_by_op,
        coll_group_size=cs.group_size_by_op,
        coll_cross_pod=float(cs.cross_pod_bytes))
