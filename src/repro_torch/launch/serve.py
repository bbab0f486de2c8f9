"""The server of the port: batched prefill, then greedy decode (port
of `repro.launch.serve`).

`serve` runs the request loop on a model the caller built (random weights,
or a checkpoint restored through `ckpt.CheckpointManager`), placed on a
device mesh or not; `run` is the command line. It serves on the host
mesh (`launch.mesh.make_host_mesh`) where the default process group has
several ranks, or with `--mesh`, the parameters placed by
`partitioning.param_shardings` (`models.model.shard_model`) and each
batch's cache by `partitioning.cache_shardings`, as the reference does;
one device without `--mesh` serves unsharded (the same tokens).
Requests are served in batches: each batch is one prefill of its prompts
and `gen - 1` decode steps against the padded cache.

A `cross_attn` arch (llama-3.2-vision-11b) is served with stub vision
embeddings, drawn for each batch after its prompts; an encoder-only arch
(hubert-xlarge) has no decode to serve and exits, as the reference's
server does.

Usage (`--arch` any of `configs.PORTED`, minicpm3-4b by default; `run`
serves the SMOKE config, as the reference's server does):
  PYTHONPATH=src python -m repro_torch.launch.serve [--arch minicpm3-4b] \\
      --requests 8 --prompt-len 64 --gen 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import entry_mesh
from repro_torch.models import init_params
from repro_torch.models import partitioning as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (Transformer, pad_cache_to,
                                      resolve_device, shard_model)
from repro_torch.train import make_serve_decode, make_serve_prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shard_cache(cache, mesh):
    """A prefill's cache placed by `partitioning.cache_shardings` (the
    layout the sharded decode step reads)."""
    def place(tree, sh):
        if isinstance(tree, dict):
            return {k: place(v, sh[k]) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(place(a, b) for a, b in zip(tree, sh))
        return tree.redistribute(mesh, sh.placements)
    return place(cache, PT.cache_shardings(cache, mesh))


def serve(cfg: ModelConfig, model: Transformer, *, batch: int,
          requests: int, prompt_len: int, gen: int, seed: int,
          device: str | torch.device = "cuda", mesh=None) -> dict:
    """Serve `requests` random prompts of `prompt_len` tokens (drawn from
    `seed`), `gen` greedy tokens each, `batch` at a time. A model with
    `cross_attn` blocks gets each batch's stub vision input, (B,
    vision_seq, d_model) bf16 normals from the same generator after the
    batch's prompts (the reference's `launch/specs.vision_inputs`).
    Returns the generated tokens and host-clock timings: `prefill_s` per
    batch and `decode_s` per batch (its `gen - 1` steps), each ended by a
    device synchronise. With `mesh` the model is placed on it
    (`shard_model`): every rank draws the same prompts, and gets the same
    tokens."""
    device = resolve_device(device)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    prefill = make_serve_prefill(cfg, mesh)
    decode = make_serve_decode(cfg, mesh)

    def gathered(logits):
        return logits if mesh is None else logits.full_tensor()
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    P, G = prompt_len, gen
    queue = list(range(requests))
    batches = [queue[i:i + batch] for i in range(0, len(queue), batch)]
    out = {"tokens": [], "prefill_s": [], "decode_s": [], "served_tokens": 0}
    t_start = time.perf_counter()
    for bi, reqs in enumerate(batches):
        prompts = torch.randint(0, cfg.vocab_size, (len(reqs), P),
                                generator=rng, device=device)
        vision = None
        if cfg.family == "vlm":
            vision = torch.randn((len(reqs), cfg.vision_seq, cfg.d_model),
                                 generator=rng, device=device).bfloat16()
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(model, prompts, vision)
        del vision
        cache = pad_cache_to(cache, cfg, S_max=P + G)
        if mesh is not None:
            cache = shard_cache(cache, mesh)
        tok = torch.argmax(gathered(logits), dim=-1)[:, None]
        _sync(device)
        t1 = time.perf_counter()
        toks = [tok]
        for i in range(G - 1):
            logits, cache = decode(model, tok, cache, P + i)
            tok = torch.argmax(gathered(logits), dim=-1)[:, None]
            toks.append(tok)
        _sync(device)
        t2 = time.perf_counter()
        out["tokens"].append(torch.cat(toks, dim=1).cpu())
        out["prefill_s"].append(t1 - t0)
        out["decode_s"].append(t2 - t1)
        out["served_tokens"] += len(reqs) * (P + G)
        print(f"batch {bi}: {len(reqs)} requests x ({P} prompt + {G} "
              f"generated)")
    out["seconds"] = time.perf_counter() - t_start
    print(f"served {requests} requests, {out['served_tokens']} tokens in "
          f"{out['seconds']:.1f}s "
          f"({out['served_tokens'] / out['seconds']:.0f} tok/s)")
    return out


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm3-4b")
    # as in the reference, --smoke is on and cannot be turned off
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", action="store_true",
                    help="serve on the host mesh also with one device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    mesh = entry_mesh(args.mesh, args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = init_params(cfg, gen, device)
    if mesh is not None:
        model = shard_model(model, mesh)
    return serve(cfg, model, batch=args.batch, requests=args.requests,
                 prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                 device=device, mesh=mesh)


if __name__ == "__main__":
    run()
