"""The training entry point of the port: data pipeline + sharded train
step + EC checkpointing (port of `repro.launch.train`).

Runs on the card unless `--device cpu` is given. It trains on the host
mesh (`launch.mesh.make_host_mesh`: the devices of the default process
group) where that group has several ranks, or with `--mesh`; the state is
placed on it by `shard_state` and the batches by
`partitioning.input_sharding`. One device without `--mesh` trains
unsharded, the same arithmetic bit for bit without DTensor's dispatch
(the reference always builds its host mesh, which costs XLA nothing).
Fault-tolerance drills the paper's operations end to end, as the
reference does:

  * periodic EC-striped checkpoint (UniLRC over the serialized state,
    gathered whole from its shards),
  * `--fail-node N --fail-at S`: node loss + crash-restart from the
    latest checkpoint (a degraded restore, zero cross-cluster bytes) +
    background reconstruction, the restored state placed on the mesh
    again,
  * straggler injection on restore reads,
  * elastic re-mesh (`elastic_remesh`): a live state moved onto another
    mesh, values unchanged.

The data pipeline yields token ids and nothing else, so an arch that needs
another input exits naming it, where the reference's entry point fails
inside its step: hubert-xlarge (frame embeddings from a stub front end)
and llama-3.2-vision-11b (stub vision embeddings beside the tokens).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 50 --ckpt-every 20 --fail-node 3 --fail-at 30 \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import BlockStore, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.codes import make_unilrc
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.device import resolve_device
from repro_torch.io import TorchBackend
from repro_torch.launch.mesh import entry_mesh
from repro_torch.models import partitioning as PT
from repro_torch.optim import AdamWConfig
from repro_torch.topo import Topology
from repro_torch.train import (TrainConfig, init_train_state,
                               make_train_step, train_state_from_jax,
                               train_state_to_tree)
from repro_torch.train.step import TrainState


def state_shardings(state: TrainState, mesh) -> dict:
    from repro_torch.launch.specs import train_state_shardings
    return train_state_shardings(state, mesh)


def shard_state(state: TrainState, mesh) -> TrainState:
    """The state placed on `mesh` by `state_shardings`, in place: its
    parameters and optimizer lists become DTensors (every rank holding
    the same whole values; nothing is sent)."""
    from repro_torch.launch.specs import place_train_state
    return place_train_state(state, mesh)


def elastic_remesh(state: TrainState, new_mesh) -> TrainState:
    """Re-shard a live train state onto a different mesh (pod loss /
    elastic scale-down). Values are preserved; only placement changes."""
    return shard_state(state, new_mesh)


def input_missing(cfg) -> str | None:
    """What the token pipeline cannot give `cfg`'s train step, or None."""
    if not cfg.embed_inputs:
        return (f"its inputs are (B, S, {cfg.d_model}) frame embeddings "
                f"from a stub front end, and the data pipeline yields "
                f"token ids")
    if cfg.family == "vlm":
        return (f"its cross-attention needs a (B, {cfg.vision_seq}, "
                f"{cfg.d_model}) vision input, which the data pipeline "
                f"does not make")
    return None


def run(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-node", type=int, default=-1)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--straggler-node", type=int, default=-1)
    ap.add_argument("--clusters", type=int, default=6)
    ap.add_argument("--nodes-per-cluster", type=int, default=8)
    ap.add_argument("--alpha", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", action="store_true",
                    help="train on the host mesh also with one device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    missing = input_missing(cfg)
    if missing:
        raise SystemExit(f"{cfg.name}: this entry point cannot train it: "
                         f"{missing}")
    device = resolve_device(args.device)
    mesh = entry_mesh(args.mesh, args.device)
    print(f"arch={cfg.name}  device={device}  mesh="
          f"{mesh and dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    # --- EC checkpoint layer (the paper's technique) -----------------------
    topo = Topology(args.clusters, args.nodes_per_cluster)
    store = BlockStore(topo)
    code = make_unilrc(args.alpha, args.clusters)
    mgr = CheckpointManager(store, code, block_size=1 << 16,
                            backend=TorchBackend(device))
    print(f"EC checkpoints: {code.name} over {topo.num_clusters} clusters "
          f"× {topo.nodes_per_cluster} nodes")

    # --- data + step -------------------------------------------------------
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    ds = SyntheticTokenDataset(dcfg)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                       clip_norm=1.0)
    tcfg = TrainConfig(accum=args.accum)
    step_fn = make_train_step(cfg, ocfg, tcfg, mesh=mesh)

    def placed(state):
        return state if mesh is None else shard_state(state, mesh)

    def fresh_state():
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        return placed(init_train_state(cfg, gen, device))

    state = fresh_state()
    step = 0
    losses = []
    t0 = time.perf_counter()
    while step < args.steps:
        if step == args.fail_at and args.fail_node >= 0:
            print(f"[step {step}] injecting failure: node {args.fail_node}")
            store.fail_node(args.fail_node)
            if args.straggler_node >= 0:
                store.set_latency(args.straggler_node, 0.2)
            # crash-restart drill: restore from the latest EC checkpoint
            if mgr.latest_step() is None:
                print("  no checkpoint yet — cold restart from step 0")
                state = fresh_state()
                step = 0
                args.fail_at = -1
                continue
            restored, report = mgr.restore()
            print(f"  degraded restore: {report.degraded_blocks}/"
                  f"{report.total_blocks_read} blocks degraded, "
                  f"cross-cluster bytes={report.cross_cluster_bytes}, "
                  f"{report.wall_seconds:.2f}s")
            if report.cross_cluster_bytes:
                raise RuntimeError("UniLRC degraded restore must be "
                                   "cluster-local")
            del state
            state = placed(train_state_from_jax(cfg, restored, device))
            del restored
            step = report.step
            rebuilt = mgr.reconstruct_failures()
            print(f"  background reconstruction: {rebuilt} blocks")
            args.fail_at = -1  # once
            continue

        tokens, labels = ds.batch(step)
        if mesh is not None:
            tokens, labels = (
                PT.distribute(torch.as_tensor(t, device=device),
                              PT.input_sharding(mesh, 2))
                for t in (tokens, labels))
        state, metrics = step_fn(state, tokens, labels)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"[step {step}] loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} ({dt:.1f}s)")
        step += 1
        if step % args.ckpt_every == 0:
            nstripes = mgr.save(train_state_to_tree(state), step)
            print(f"[step {step}] EC checkpoint: {nstripes} stripes "
                  f"({code.name})")

    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    run()
