"""The server of the port: batched prefill, then greedy decode (port
of `repro.launch.serve`).

`serve` runs the request loop on a model the caller built (random weights,
or a checkpoint restored through `ckpt.CheckpointManager`); `run` is the
command line. Requests are served in batches: each batch is one prefill of
its prompts and `gen - 1` decode steps against the padded cache.

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
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, pad_cache_to, resolve_device
from repro_torch.train import make_serve_decode, make_serve_prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, model: Transformer, *, batch: int,
          requests: int, prompt_len: int, gen: int, seed: int,
          device: str | torch.device = "cuda") -> dict:
    """Serve `requests` random prompts of `prompt_len` tokens (drawn from
    `seed`), `gen` greedy tokens each, `batch` at a time. A model with
    `cross_attn` blocks gets each batch's stub vision input, (B,
    vision_seq, d_model) bf16 normals from the same generator after the
    batch's prompts (the reference's `launch/specs.vision_inputs`).
    Returns the generated tokens and host-clock timings: `prefill_s` per
    batch and `decode_s` per batch (its `gen - 1` steps), each ended by a
    device synchronise."""
    device = resolve_device(device)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    prefill = make_serve_prefill(cfg)
    decode = make_serve_decode(cfg)
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
        tok = torch.argmax(logits, dim=-1)[:, None]
        _sync(device)
        t1 = time.perf_counter()
        toks = [tok]
        for i in range(G - 1):
            logits, cache = decode(model, tok, cache, P + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = init_params(cfg, gen, device)
    return serve(cfg, model, batch=args.batch, requests=args.requests,
                 prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                 device=device)


if __name__ == "__main__":
    run()
