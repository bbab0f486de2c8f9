#!/usr/bin/env python3
"""Times training steps on the card: minicpm3-4b (MLA) at its full width,
cut to 8 layers, at `chip_smoke.TRAIN`'s settings (8 x 2,048 tokens a
step, accum 2, block remat, AdamW), with weights and batches from a seed.

Prints one line a step (wall ms between synchronisations, loss, the
attention route's counters) and, last, a JSON object: the median step,
the device's bytes after the state is built and its peak over the steps
(`torch.cuda.max_memory_allocated`), and the card's name and power limit.
With `--top N`, one more step runs under `torch.profiler`
(`chip_smoke.device_ops`) and the line before the JSON lists its N device
ops of most time (name, ms, count).

`--src` takes the port's package from another checkout's `src`, so that
one script times two versions of the package in one call on one card:

    python3 tools/train_step_bench.py [--steps 4] [--src DIR] [--top N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, LAYERS, SEED = "minicpm3-4b", 8, 2505


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--top", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_step_bench: no CUDA card")
    # as chip_smoke.py sets them: fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import Segment, layers
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    T = chip_smoke.TRAIN
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    full = get_config(ARCH)
    (seg,) = full.segments
    cfg = dataclasses.replace(full, name=f"{ARCH}-{LAYERS}l",
                              segments=(Segment(seg.blocks, LAYERS),))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    state = init_train_state(cfg, gen, "cuda")
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, T["seq"],
                                          T["batch"], seed=SEED))
    step = make_train_step(
        cfg, AdamWConfig(lr=T["lr"], warmup_steps=T["warmup_steps"],
                         total_steps=args.steps + 1,
                         clip_norm=T["clip_norm"]),
        TrainConfig(accum=T["accum"], remat=T["remat"]))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(args.steps + 1):         # step 0 warms up
        tokens, labels = ds.batch(i)
        fak.reset_counts()
        layers.reset_blockwise_calls()
        per_head = getattr(layers, "mla_per_head_calls", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, tokens, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(ms)
        counts = dict(launches=fak.launches, plain_calls=fak.plain_calls,
                      blockwise_calls=layers.blockwise_calls,
                      mla_per_head_calls=(
                          None if per_head is None
                          else layers.mla_per_head_calls - per_head))
        print(f"step {i} ms={ms:.1f} loss={float(metrics['loss']):.5f} "
              f"counts={json.dumps(counts)}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    if args.top:
        # one more step (the state is updated in place) under the profiler
        ops = chip_smoke.device_ops(
            lambda i: step(state, *ds.batch(args.steps + 1)), 1)
        top = sorted(ops, key=lambda o: -o[1])[:args.top]
        print("top " + json.dumps(dict(
            device_ms=round(sum(ms for _, ms, _ in ops), 1),
            kernels=[(k[:90], round(ms, 1), n) for k, ms, n in top])),
            flush=True)
    print(json.dumps(dict(
        package=str(pathlib.Path(repro_torch.__file__).parent),
        arch=cfg.name, params=cfg.param_count(), batch=T["batch"],
        seq=T["seq"], accum=T["accum"], remat=T["remat"],
        steps=len(times), step_ms=[round(t, 1) for t in times],
        median_step_ms=statistics.median(times),
        state_bytes=state_bytes,
        peak_bytes=peak, card=card)),
        flush=True)


if __name__ == "__main__":
    main()
