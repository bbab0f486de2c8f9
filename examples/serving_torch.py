"""Serving drill on the PyTorch port: batched prefill + decode with a KV
cache, plus an EC-protected "model registry" restore: the serving-side
use of the paper's technique (weights striped across the cluster; a
server that loses a node still loads the model, degraded, with zero
cross-cluster reads).

The port of `examples/serving.py`; it imports only `repro_torch`, and
runs on the card unless --device cpu is given.

Run:  PYTHONPATH=src python examples/serving_torch.py [--arch minicpm3-4b]
      [--device cpu]
      (MLA default: its latent KV cache is 9x smaller than GQA's)
"""
import argparse
import time

import torch

from repro_torch.ckpt import BlockStore, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.codes import make_unilrc
from repro_torch.device import resolve_device
from repro_torch.io import Priority, RequestFrontend, TorchBackend
from repro_torch.models import init_params, params_from_jax, params_to_tree
from repro_torch.models.model import pad_cache_to
from repro_torch.topo import Topology
from repro_torch.train import make_serve_decode, make_serve_prefill


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = init_params(cfg, gen, device)

    # --- EC-protected weight registry ------------------------------------
    topo = Topology(6, 8)
    store = BlockStore(topo)
    mgr = CheckpointManager(store, make_unilrc(1, 6), block_size=1 << 14,
                            backend=TorchBackend(device))
    mgr.save(params_to_tree(model), step=0)
    store.fail_node(2)  # a registry node is down when the server boots
    params_restored, report = mgr.restore(0)
    print(f"weight restore: degraded={report.degraded} "
          f"({report.degraded_blocks} blocks), cross-cluster bytes="
          f"{report.cross_cluster_bytes}")
    assert report.cross_cluster_bytes == 0
    model = params_from_jax(cfg, params_restored, device)

    # --- mixed registry traffic through the request front-end ------------
    # Many servers hit the degraded registry at once while background
    # repair + scrub run: the front-end coalesces same-pattern degraded
    # reads into one batched launch per pattern and keeps client reads
    # ahead of the background storm (priority classes).
    fe = RequestFrontend(mgr.codec, background_ops_per_flush=32)
    metas = mgr.stripes_of(0)
    meta_of = {m.stripe_id: m for m in metas}
    lost = store.blocks_on_node(2)
    client = [fe.submit_client_read(m) for m in metas[:4]]
    lost_data = [(sid, b) for sid, b in lost if b < mgr.code.k][:8]
    degraded = [fe.submit_degraded_read(meta_of[sid], b)
                for sid, b in lost_data]
    fe.submit_rebuild(lost, exclude_node=2)
    fe.drain()
    scrub = fe.submit_scrub(metas)      # integrity pass over healed stripes
    fe.drain()
    for h in client + degraded:
        h.result()                      # byte-correct or raise
    sc = scrub.result()
    print(f"scrub: {sc.checked}/{sc.stripes} stripes verified, "
          f"{len(sc.mismatched)} parity mismatches")
    assert not sc.mismatched
    for prio in Priority:
        cls = fe.stats[prio]
        if not cls.requests:
            continue
        print(f"  {prio.name:<13} requests={cls.requests:<3} "
              f"blocks={cls.blocks:<4} launches={cls.launches:<3} "
              f"mean_latency={cls.mean_latency_s * 1e3:.1f}ms "
              f"cross_bytes={cls.cross_bytes}")
    assert (fe.stats[Priority.CLIENT_READ].mean_latency_s
            <= fe.stats[Priority.BACKGROUND].mean_latency_s)

    # --- batched prefill --------------------------------------------------
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=device)
    prefill = make_serve_prefill(cfg)
    decode = make_serve_decode(cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    logits, cache = prefill(model, prompts)
    sync()
    t_prefill = time.perf_counter() - t0
    cache = pad_cache_to(cache, cfg, S_max=P + G)

    # --- decode loop -------------------------------------------------------
    tok = torch.argmax(logits, dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(G - 1):
        logits, cache = decode(model, tok, cache, P + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out_tokens, dim=1)
    assert gen_tokens.shape == (B, G)
    assert bool(torch.isfinite(logits.float()).all())
    print(f"prefill: {B}×{P} tokens in {t_prefill:.2f}s "
          f"({B * P / t_prefill:.0f} tok/s)")
    print(f"decode:  {B}×{G - 1} tokens in {t_decode:.2f}s "
          f"({B * (G - 1) / t_decode:.0f} tok/s)")
    print(f"sample tokens: {gen_tokens[0, :10].tolist()}")
    print("serving OK")


if __name__ == "__main__":
    main()
