#!/usr/bin/env python3
"""Times one call of the GF(2^8) coding kernel on one CUDA card, per call
and on the device alone, for the checkout at `--root`.

Per call is CUDA events around one call with the device waiting for the
host, so the wrapper's host work (checks, allocation, the ctypes call and
the host code's plan) counts; device time queues each call behind ~1 ms
of device spin, so the host has enqueued it before the first event. Both
are medians over `--reps` calls, at three call sites:

  gf delta        `gf_bitmatmul`, S=1, 21 x 1, B = 1 MiB
  gf encode       `gf_bitmatmul`, S=8, 30 x 180 (UniLRC 180-of-210), 1 MiB
  ops delta       `kernels.ops.apply_matrix` at the delta terms (the
                  path's own call, planning included)
  plan delta      where the checkout has the launch planner: the host
                  microseconds of planning that call as `kernels/ops.py`
                  plans it, a mean over 100,000 plans

`--root` names another checkout (an unpacked `git archive` of an earlier
commit, say), whose kernels are built from its own sources into its own
`build/`, so that two versions compare within one run on one card: run
them in turns (older, newer, newer, older). Prints the card's name and
power limit, then one JSON line.

Run from the root of the repo, on a machine with a card and nvcc:
    python3 tools/gf_call_bench.py [--root DIR] [--reps 200]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPIN_CYCLES = 2_000_000
MIB = 1 << 20


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if not smi:
        return "nvidia-smi not found"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    return (out.stdout or out.stderr).strip().splitlines()[0]


def time_ms(fn, reps: int, spin: bool) -> float:
    import torch
    fn()                                                    # warm up
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    from repro_torch.core import make_unilrc
    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import ops
    if not pathlib.Path(gfk.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"repro_torch came from {gfk.__file__}, not {root}")

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)
    delta = rng.integers(1, 256, (21, 1), dtype=np.uint8)
    encode = np.asarray(make_unilrc(2, 10).A, dtype=np.uint8)
    out = {"root": str(root), "reps": args.reps}
    for name, M, S in (("gf delta", delta, 1), ("gf encode", encode, 8)):
        cols = torch.from_numpy(gf_bit_columns(M)).to(dev)
        data = torch.randint(0, 256, (S, M.shape[1], MIB), dtype=torch.uint8,
                             device=dev, generator=gen)
        got = gfk.gf_bitmatmul(cols, data)  # repro-lint: allow=RA001
        if not torch.equal(got, gfk.gf_bitmatmul_plain(cols, data)):
            raise SystemExit(f"{name}: the kernel differs from the plain "
                             "version")

        def call(cols=cols, data=data):
            gfk.gf_bitmatmul(cols, data)  # repro-lint: allow=RA001
        out[name] = {"ms": time_ms(call, args.reps, spin=False),
                     "device_ms": time_ms(call, args.reps, spin=True)}
    data = torch.randint(0, 256, (1, MIB), dtype=torch.uint8, device=dev,
                         generator=gen)
    if not torch.equal(ops.apply_matrix(delta, data),
                       gfk.gf_bitmatmul_plain(
                           torch.from_numpy(gf_bit_columns(delta)).to(dev),
                           data[None])[0]):
        raise SystemExit("ops delta: differs from the plain version")
    out["ops delta"] = {
        "ms": time_ms(lambda: ops.apply_matrix(delta, data), args.reps,
                      spin=False),
        "device_ms": time_ms(lambda: ops.apply_matrix(delta, data),
                             args.reps, spin=True)}
    from repro_torch.kernels import autotune
    if hasattr(autotune, "plan_matmul_tiles"):
        def plan() -> None:
            ops._grid(autotune.plan_matmul_tiles(
                1, 21, MIB, S=1, sms=autotune.device_sms(data.device),
                resident=gfk.resident_ctas(21, 1, data.device)))
        plan()
        t0 = time.perf_counter()
        for _ in range(100_000):
            plan()
        out["plan delta"] = {"us": (time.perf_counter() - t0) * 10}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
