"""Readings that the correctness limits are set from, for one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control 4 [--first-seed N]

For each seed, a run of the cell with `check_batches` batches in its
window (`harness.run`), and the check's numbers: the program's readings,
whose largest over sound runs is a limit's lower reading. For the first
`--control` seeds, the control on the same prompts: the reference in fp8
put in the program's place (`check.control`), whose smallest reading is a
limit's upper one. One JSON line per reading on standard output. Needs a
CUDA card, as a run does.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)

    import gc

    import torch

    from portbench import check, harness, spec
    from portbench.inputs import Prompts, Weights

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load(args.workload)
    c, tr = cell.config["config"], cell.traffic
    keys = ("cache_err", "logit_err", "token_gap", "route_gap",
            "replay_diff", "cache_err_max", "logit_err_each",
            "token_gap_each")
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        numbers: dict = {}
        t = time.perf_counter()
        res = harness.run(cell, seed, 0.0, False, device=device, t0=t,
                          batches=cell.limits["check_batches"],
                          numbers=numbers)
        print(json.dumps({"cell": cell.cell, "side": "program", "seed": seed,
                          "correct": res["correct"],
                          **{k: numbers[k] for k in keys}}), flush=True)
        if i >= args.control:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        stream = Prompts(seed, "prompts", c["vocab_size"], tr["batch"],
                         tr["prompt_len"], device)
        prompts = torch.cat([stream.next()
                             for _ in range(cell.limits["check_batches"])])
        weights = Weights(cell.config, seed, device)
        numbers = check.control(cell.config, weights, prompts)
        correct, _ = check.judge(numbers, cell.limits)
        print(json.dumps({"cell": cell.cell, "side": "control fp8",
                          "seed": seed, "correct": correct,
                          **{k: numbers[k] for k in keys}}), flush=True)
        del weights, prompts, stream
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
