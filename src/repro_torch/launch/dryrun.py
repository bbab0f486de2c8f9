"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell on
256 or 512 fake devices (port of `repro.launch.dryrun`).

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices and reads XLA's memory analysis, cost analysis and HLO. The
port builds the production mesh on a fake process group
(`launch.mesh.make_production_mesh`), the cell's model, state, inputs
and cache as fake tensors placed on it (`launch.specs.cell_args`), and
runs the cell's step once under fake tensors: the sharding coherence
proof is that every op of the step finds its shards. It reads:

  memory       argument_size_in_bytes, the local shard bytes of the
               step's inputs on rank 0, and the peak of live tensor bytes
               during the step from `MemTracker` (`{"error": ...}` where
               it cannot be had, as the reference reports on the CPU)
  cost         the trace's per-device FLOPs and bytes (`launch.hlo_cost`)
  collectives  per kind, bytes and counts, cross-pod bytes (`launch.hlo`)
  op_audit     reshape / transpose / copy ops and the kernel operators

into build/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json. There is no
compile, so `lower_seconds` and `compile_seconds` become `trace_seconds`;
the reference's `--attn-schedule` has no counterpart (the port's
attention has one schedule) and `--save-hlo` becomes `--save-trace`.

The trace runs on any host: no card, no allocation. Attention takes the
flash kernel's operator (`torch.ops.repro_torch.flash_attention_fwd`)
through its fake implementation, the card's route, not the plain
version.

`--all` runs one subprocess per cell (a process holds one process group,
and a pathological cell cannot poison the rest), `--jobs` of them at a
time, and prints the summary.
"""
from __future__ import annotations

import argparse
import json
import logging
import pathlib
import subprocess
import sys
import tempfile
import time

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
           / "dryrun_torch")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _arg_tensors(args):
    """Every tensor a cell's step reads: parameters, optimizer state,
    steps, inputs, cache."""
    import torch

    from repro_torch.models.model import Transformer
    from repro_torch.train.step import TrainState
    for a in args:
        if isinstance(a, TrainState):
            yield from a.model.parameters()
            for name in ("master", "m", "v"):
                yield from a.opt[name]
            yield a.opt["step"]
            yield a.step
        elif isinstance(a, Transformer):
            yield from a.parameters()
        else:
            yield from (t for t in _leaves(a) if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape: str, mesh_kind: str, *, remat: str = "block",
             accum: int = 1, tag: str = "", seq_parallel: bool = False,
             save_trace: bool = False) -> dict:
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo import TraceRecorder, collective_stats, \
        count_ops
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, cell_status
    from repro_torch.launch.specs import cell_args, fake_mode, local_bytes
    from repro_torch.models import forward
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, make_serve_decode,
                                   make_serve_prefill, make_train_step)

    status = cell_status(arch, shape)
    if status != "run":
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": status}

    cfg = get_config(arch)
    spec = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="cpu")
    t0 = time.perf_counter()
    kind, args, shards, donate = cell_args(cfg, spec, mesh)

    tcfg = TrainConfig(accum=accum, remat=remat, seq_parallel=seq_parallel)
    if kind == "train":
        fn = make_train_step(cfg, AdamWConfig(), tcfg, mesh=mesh)
    elif kind == "prefill":
        fn = make_serve_prefill(cfg, mesh=mesh)
    elif kind == "encode":
        def fn(model, embeds):
            logits, _, _ = forward(model, embeds, mode="train", mesh=mesh)
            return logits
    elif kind == "decode":
        fn = make_serve_decode(cfg, mesh=mesh)
    else:
        raise ValueError(kind)

    if kind != "train":
        # MemTracker hooks the parameters' gradients: a served model's
        # (fake) parameters are made trainable; its forward runs under
        # `inference_mode` all the same
        args[0].requires_grad_(True)
    arg_bytes = sum(local_bytes(t) for t in _arg_tensors(args))
    memory: dict = {"argument_size_in_bytes": arg_bytes}
    rec = TraceRecorder(mesh, pod_size=256)
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
    except Exception as e:                  # noqa: BLE001 (reported)
        tracker, memory["error"] = None, repr(e)
    with fake_mode():
        if tracker is None:
            with rec:
                fn(*args)
        else:
            with rec, tracker:
                fn(*args)
            try:
                peak = tracker.get_tracker_snapshot("peak")
                memory["peak_bytes_per_device"] = int(
                    sum(v.get("Total", 0) for v in peak.values()))
            except Exception as e:          # noqa: BLE001 (reported)
                memory["error"] = repr(e)
    t_trace = time.perf_counter() - t0
    trace = rec.trace
    sc = analyze(trace, pod_size=256)
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
        "kind": kind, "tag": tag,
        "options": {"remat": remat, "accum": accum,
                    "seq_parallel": seq_parallel},
        "trace_seconds": round(t_trace, 2),
        "num_devices": mesh.size(),
        "memory": memory,
        "cost": {"flops": sc.flops, "bytes_accessed": sc.bytes},
        "collectives": collective_stats(trace, pod_size=256).to_json(),
        "static_cost": sc.to_json(),
        "op_audit": count_ops(trace, ("reshape", "transpose", "copy",
                                      "custom")),
        "op_count": len(trace.ops),
    }
    if save_trace:
        tpath = ART_DIR / f"{arch}__{shape}__{mesh_kind}{tag}.trace.json"
        tpath.write_text(json.dumps({"mesh_shape": trace.mesh_shape,
                                     "ops": trace.to_json()}))
        result["trace_path"] = str(tpath)
    return result


def artifact_path(arch: str, shape: str, mesh_kind: str, tag: str = ""):
    return ART_DIR / f"{arch}__{shape}__{mesh_kind}{tag}.json"


def _run_all(args) -> None:
    from repro_torch.launch.shapes import all_cells
    todo, failures = [], []
    for a, s, st in all_cells():
        for mesh_kind in ("single", "multi"):
            path = artifact_path(a, s, mesh_kind, args.tag)
            if st != "run":
                path.write_text(json.dumps(
                    {"arch": a, "shape": s, "mesh": mesh_kind,
                     "status": st}, indent=2))
                print(f"[skip] {a} x {s} x {mesh_kind}: {st}")
            elif path.exists() and not args.force:
                print(f"[cached] {a} x {s} x {mesh_kind}")
            else:
                todo.append((a, s, mesh_kind))
    running: list = []
    t_all = time.perf_counter()

    def reap() -> None:
        """Collects the first cell that has ended, or outlived the timeout
        (killed), if any."""
        for item in list(running):
            (a, s, mesh_kind), proc, log, t0 = item
            dt = time.perf_counter() - t0
            if proc.poll() is None:
                if dt < args.timeout:
                    continue
                proc.kill()
                proc.wait()
            running.remove(item)
            log.seek(0)
            err = log.read() if dt < args.timeout else "TIMEOUT"
            log.close()
            if proc.returncode == 0:
                print(f"[ok]   {a} x {s} x {mesh_kind}  ({dt:.0f}s)",
                      flush=True)
            else:
                failures.append((a, s, mesh_kind, err[-2000:]))
                print(f"[FAIL] {a} x {s} x {mesh_kind}  ({dt:.0f}s)\n"
                      f"{err[-2000:]}", flush=True)
            return

    for a, s, mesh_kind in todo:
        while len(running) >= args.jobs:
            reap()
            time.sleep(0.2)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--mesh", mesh_kind,
               "--remat", args.remat, "--accum", str(args.accum),
               "--tag", args.tag]
        if args.seq_parallel:
            cmd.append("--seq-parallel")
        # stderr to a file: a pipe nobody reads while the cell runs
        # could fill and stall it
        log = tempfile.TemporaryFile("w+")
        running.append(((a, s, mesh_kind),
                        subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                         stderr=log, text=True),
                        log, time.perf_counter()))
    while running:          # in the order they end: each time is its own
        reap()
        time.sleep(0.2)
    print(f"\n{len(todo) - len(failures)} of {len(todo)} cells traced in "
          f"{time.perf_counter() - t_all:.0f}s")
    if failures:
        print(f"{len(failures)} cell(s) failed")
        sys.exit(1)
    print("All cells traced.")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell on both meshes via "
                         "subprocesses")
    ap.add_argument("--remat", default="block", choices=("none", "block"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--tag", default="", help="artifact filename suffix "
                    "(perf-iteration variants)")
    ap.add_argument("--save-trace", action="store_true",
                    help="also write the op trace (launch.hlo_debug reads "
                         "it)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells with existing artifacts")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at a time")
    args = ap.parse_args()

    ART_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        _run_all(args)
        return

    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape required")
    result = run_cell(args.arch, args.shape, args.mesh, remat=args.remat,
                      accum=args.accum, tag=args.tag,
                      seq_parallel=args.seq_parallel,
                      save_trace=args.save_trace)
    path = artifact_path(args.arch, args.shape, args.mesh, args.tag)
    path.write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))
    if result["status"] != "ok" and not result["status"].startswith("skip"):
        sys.exit(1)


if __name__ == "__main__":
    main()
