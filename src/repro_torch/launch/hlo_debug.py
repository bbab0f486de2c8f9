"""Debug helper: the top contributors to a collective kind in a traced
step, by module path (port of `repro.launch.hlo_debug`). Usage:
  python -m repro_torch.launch.hlo_debug <trace.json> [kind-substring] [n]

The reference weights each HLO instruction by `multipliers`, its
computation's trip count through the loop nest. A trace of the port has
one record per executed op, loops unrolled (`launch.hlo_cost`), so the
weight of a (module, kind) row is simply its count.
"""
from __future__ import annotations

import json
import pathlib
import sys
from collections import defaultdict

from .hlo import OpRecord, Trace


def top_contributors(trace: Trace, op_filter: str = "all-gather",
                     n: int = 10) -> list[tuple]:
    """[(total bytes, count, bytes per call, module, kind, group)] of the
    collectives whose kind contains `op_filter`, largest first."""
    rows: dict = defaultdict(lambda: [0, 0])
    for rec in trace.ops:
        if rec.kind is None or op_filter not in rec.kind:
            continue
        key = (rec.module, rec.kind, rec.group, rec.out_bytes)
        rows[key][0] += rec.out_bytes
        rows[key][1] += 1
    out = [(total, count, key[3], key[0], key[1], key[2])
           for key, (total, count) in rows.items()]
    out.sort(key=lambda r: r[0], reverse=True)
    return out[:n]


def load(path) -> Trace:
    """A trace that `launch.dryrun --save-trace` wrote."""
    data = json.loads(pathlib.Path(path).read_text())
    return Trace([OpRecord(**{**r, "group": tuple(r["group"])})
                  for r in data["ops"]], data["mesh_shape"])


def main():
    path = sys.argv[1]
    opf = sys.argv[2] if len(sys.argv) > 2 else "all-gather"
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    for total, count, each, module, kind, group in top_contributors(
            load(path), opf, n):
        print(f"{total / 2**30:9.2f}GB x{count:6d} each="
              f"{each / 2**20:8.1f}MB {kind:15s} over {'x'.join(group):12s}"
              f" {module}")


if __name__ == "__main__":
    main()
