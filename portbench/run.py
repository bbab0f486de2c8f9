"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The cell is
an entry of `workloads` in BENCHMARK.json. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics with `--trace 0`, its per-layer metrics
with `--trace 1`), `device`, with `--trace 1` `breakdown`, and `check`
last: each number the correctness check compared, beside its limit. The
same numbers are the last lines of standard error. Without a card, or
with fewer than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it prints no result and exits 3.
"""
import os
import pathlib
import time


def _process_start() -> float:
    """The `time.perf_counter()` reading at which this process started
    (Linux: its start time against the uptime; elsewhere: now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache the program or its libraries keep, at fixed paths inside
# the checkout (the port's own kernel build is `build/repro_torch/`)
CACHE = HERE / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Modules loaded in this process whose top-level name (the part
    before the first dot, compared whole) is JAX's or the JAX package's."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN
                  and sys.modules[name] is not None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    cell = spec.load(args.workload)
    want = next(w["chips"] for w in spec.benchmark()["workloads"]
                if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"portbench: the cell needs {want} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" present. No result.", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device=device, t0=T0)
    # read after the window, so that it is not in the set-up's time
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        card = f"nvidia-smi: {err}"
    print(f"portbench card: {card}", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}. No result.", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
