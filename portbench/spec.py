"""What one cell is: found by name from `BENCHMARK.json` and the files
beside the harness.

- `configs/<config>.json`: the model configuration (published widths,
  layers kept, the port's arch name, what was cut, assumed and departed);
- `traffic/<traffic>.json`: the mix (batch, prompt length, tokens
  generated, the loop);
- `limits/<cell>.json`: the numbers the correctness check compares, each
  with its limit and the readings it was set from;
- `metrics/<metric>.py`: one reader per per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Spec:
    cell: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]            # the per-layer metrics of this cell


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load(cell: str, root: pathlib.Path = ROOT) -> Spec:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    w = cells[cell]
    config = _json(HERE / "configs" / f"{w['config']}.json")
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _json(HERE / "limits" / f"{cell}.json")

    def here(m: dict) -> bool:
        return "workloads" not in m or cell in m["workloads"]
    return Spec(cell, config, traffic, limits,
                [m for m in bench["end_to_end"] if here(m)],
                [m for m in bench["per_layer"] if here(m)])


def reader(metric: str):
    """The module that reads one per-layer metric: `metrics/<name>.py`,
    with `read(readings) -> float | None` and `PROBES`, the program's
    functions (`{probe name: "module:function"}`) whose calls it times."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
