#!/usr/bin/env python3
"""Where the train witness's card-vs-CPU gap comes from (`chip_smoke.py`
phases 11b and 11d).

For each arch and seed: one initial state, from the seed on the CPU, at
the witness's width and depth (`chip_smoke.WITNESS`), takes the witness's
first train step (`chip_smoke.TRAIN`'s settings, batch 0) four ways:

  card      bf16 on the card, as the witness runs it;
  card_fr   bf16 on the card with cuBLAS's reduced-precision bf16
            reductions off (`allow_bf16_reduced_precision_reduction`);
  cpu       bf16 on the CPU, as the witness runs it;
  fp32      every leaf in fp32 on the CPU, the step without bf16 rounding.

The first moment m of each (0.1 x the clipped gradient) is compared leaf
by leaf as a share of the fp32 step's max |m| on that leaf; `card~cpu` is
the witness's own reading (a share of the CPU's max |m|). Prints, for each
arch and seed, the leaves with the largest `card~cpu` and, for each way,
its worst leaf against fp32; the last line is a JSON object of every
reading.

Run from the root of the repo, on a machine with a card:
    python3 tools/witness_drift.py [--archs llama3.2-3b minicpm3-4b]
                                   [--seeds 2505 1 2] [--top 4]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def first_m(state, step, tokens, labels) -> list:
    """The first moment of each leaf after one step, on the CPU, fp32."""
    state, _ = step(state, tokens, labels)
    return [m.detach().float().cpu() for m in state.opt["m"]]


def drift(arch: str, seed: int) -> dict:
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.models import Segment
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_from_jax,
                                   train_state_to_tree)

    W, T = chip_smoke.WITNESS, chip_smoke.TRAIN
    full = get_config(arch)
    (seg,) = full.segments
    cfg = dataclasses.replace(full, name=f"{arch}-{W['layers']}l",
                              segments=(Segment(seg.blocks, W["layers"]),))
    host = init_train_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    tree = train_state_to_tree(host)
    names = [n for n, _ in host.model.named_parameters()]
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, W["seq"],
                                          W["batch"], seed=0))
    tokens, labels = ds.batch(0)
    step = make_train_step(
        cfg, AdamWConfig(lr=T["lr"], warmup_steps=T["warmup_steps"],
                         total_steps=W["steps"], clip_norm=T["clip_norm"]),
        TrainConfig(accum=T["accum"], remat=T["remat"]))

    ms, secs = {}, {}
    matmul = torch.backends.cuda.matmul
    for way in ("card", "card_fr", "cpu", "fp32"):
        t0 = time.perf_counter()
        dev = "cuda" if way.startswith("card") else "cpu"
        state = host if way == "cpu" else train_state_from_jax(cfg, tree, dev)
        if way == "fp32":
            state.model.float()
        keep = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = way != "card_fr"
        try:
            ms[way] = first_m(state, step, tokens, labels)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = keep
        secs[way] = round(time.perf_counter() - t0, 2)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    del host

    def share(a, b):
        scale = b.abs().max().item()
        return (a - b).abs().max().item() / scale if scale else 0.0

    leaves = {}
    for i, name in enumerate(names):
        ref = ms["fp32"][i]
        leaves[name] = {f"{w}~fp32": share(ms[w][i], ref)
                        for w in ("card", "card_fr", "cpu")}
        leaves[name]["card~cpu"] = share(ms["card"][i], ms["cpu"][i])
        leaves[name]["card_fr~cpu"] = share(ms["card_fr"][i], ms["cpu"][i])
    return dict(arch=arch, seed=seed, seconds=secs, leaves=leaves)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+",
                    default=["llama3.2-3b", "minicpm3-4b"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2505, 1, 2])
    ap.add_argument("--top", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("witness_drift: no CUDA card")
    # as chip_smoke.py sets them: fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    for arch in args.archs:
        for seed in args.seeds:
            r = drift(arch, seed)
            runs.append(r)
            lv = r["leaves"]
            print(f"{arch} seed {seed} seconds {r['seconds']}")
            for name in sorted(lv, key=lambda n: -lv[n]["card~cpu"]
                               )[:args.top]:
                print("  " + name + " " + " ".join(
                    f"{k}={v:.3e}" for k, v in lv[name].items()))
            for k in ("card~fp32", "card_fr~fp32", "cpu~fp32", "card~cpu",
                      "card_fr~cpu"):
                worst = max(lv, key=lambda n: lv[n][k])
                print(f"  worst {k}: {lv[worst][k]:.3e} ({worst})",
                      flush=True)
    print(json.dumps(dict(card=card, runs=runs)))


if __name__ == "__main__":
    main()
