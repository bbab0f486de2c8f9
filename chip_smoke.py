#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

Drives the port's main path on one CUDA card and checks every byte:

  1. environment: torch, CUDA and nvcc versions, the card's name and
     power limit;
  2. build: the CUDA kernels from `src/repro_torch/csrc/`, compiled by
     nvcc into `build/repro_torch/` at first use;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes and its edges (byte equality for the coding
     kernels; 2e-2 in bf16 and 2e-5 / 1e-4 in fp32 for attention), with its
     median time over CUDA events, the plain version's time, the bound and
     bound share and, for attention, PyTorch's
     `scaled_dot_product_attention` as a yardstick; ptxas must report 0
     spill bytes for every instantiation of the two sm90 kernels;
  4. stripe path: UniLRC 180-of-210 (alpha=2, z=10) on 10 clusters x 24
     nodes, 1 MiB blocks, `TorchBackend("cuda")`: a 4 GiB streamed write
     in windows of 8 stripes, a full read, one node lost (degraded read,
     recovery, rebuild), one cluster lost (21 erasures per stripe) and a
     few delta-parity updates; launch bounds asserted;
  6. serve path: llama3.2-3b at full width (random weights from a seed)
     saved as a 180-of-210 checkpoint through `CheckpointManager`, one
     node lost, restored degraded (zero cross-cluster bytes, every tensor
     byte-identical), rebuilt, and served: 8 requests of 2048 prompt + 32
     generated tokens in batches of 4, every prefill attention layer
     through the flash kernel; prefill + decode checked against prefill;
  5. a JSON line of per-kernel numbers, the card line, and the result
     line `{"ok": true, "device": {...}}` last.

Any failed check exits non-zero before the result line. Without a CUDA
device, or without the repo's `src/repro_torch` beside it, it exits 1.

Run from the root of the repo:  python3 chip_smoke.py
"""
from __future__ import annotations

import faulthandler
import gc
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 rate outside tensor cores
GIB = 1 << 30
MIB = 1 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=False)
    return (out.stdout + out.stderr).strip()


def time_ms(fn, reps: int) -> float:
    """Median device time of `fn()` in ms, one CUDA-event pair per call."""
    import torch
    fn()                                                    # warm up
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int = 0,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def ptxas_spills(log: str, kernel: str) -> dict[str, int]:
    """Spill store + load bytes that `nvcc -Xptxas -v` reports for each
    compiled function whose mangled name contains `kernel`."""
    spills, name = {}, None
    for line in log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            name = props.group(1)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found and name and kernel in name:
            spills[name] = int(found.group(1)) + int(found.group(2))
        if found:
            name = None
    return spills


def main_path(backend, BS: int, payload, rng) -> None:
    """The port's main path: UniLRC 180-of-210 on 10 x 24 nodes through
    `backend`, windows of 8 stripes. Checks every byte and the launch
    bounds; exits on the first failed check."""
    import numpy as np
    import torch

    from repro_torch.ckpt import BlockStore, StripeCodec
    from repro_torch.core import make_unilrc
    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.io import NumpyBackend
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import ops
    from repro_torch.topo import Topology

    def sync():
        if backend.device.type == "cuda":
            torch.cuda.synchronize()

    code = make_unilrc(alpha=2, z=10)
    S_WIN = 8
    store = BlockStore(Topology(num_clusters=10, nodes_per_cluster=24))
    codec = StripeCodec(code, store, block_size=BS, backend=backend,
                        max_batch_stripes=S_WIN)
    nstripes = math.ceil(payload.size / (code.k * BS))
    windows = math.ceil(nstripes / S_WIN)

    # host seconds inside the store's bulk calls, to attribute the host time
    store_s = {"put_s": 0.0, "get_s": 0.0}

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            store_s[key] += time.perf_counter() - t0
            return out
        return call
    store.put_many = timed("put_s", store.put_many)
    store.get_many = timed("get_s", store.get_many)

    def reset():
        ops.reset_kernel_launch_counts()
        backend.reset_times()
        store_s.update(put_s=0.0, get_s=0.0)
        sync()
        return time.perf_counter()

    def report(name, t_start, nbytes, launches_expect=None):
        sync()
        wall = time.perf_counter() - t_start
        t = backend.take_times()
        counts = ops.kernel_launch_snapshot()
        device_ms = t["h2d_ms"] + t["kernel_ms"] + t["d2h_ms"]
        phase(name, GiB=f"{nbytes / GIB:.3f}", seconds=f"{wall:.3f}",
              GiB_s=f"{nbytes / GIB / wall:.3f}",
              device_share=f"{device_ms / 1e3 / wall:.4f}",
              h2d_ms=f"{t['h2d_ms']:.1f}", kernel_ms=f"{t['kernel_ms']:.1f}",
              d2h_ms=f"{t['d2h_ms']:.1f}", pin_s=f"{t['pin_s']:.3f}",
              stage_s=f"{t['stage_s']:.3f}",
              land_s=f"{t['land_s']:.3f}", put_s=f"{store_s['put_s']:.3f}",
              get_s=f"{store_s['get_s']:.3f}", launches=json.dumps(counts))
        if launches_expect is not None:
            check(counts == launches_expect,
                  f"{name}: launches {counts} != bound {launches_expect}")
        return counts

    def stored(sid, b):
        return np.frombuffer(store._blocks[(sid, b)], np.uint8)

    # 4.1 streamed write
    t = reset()
    metas = codec.write_stream(payload, window_stripes=S_WIN)
    report("write_stream", t, payload.size, {"gf_bitmatmul": windows})
    check(len(metas) == nstripes == 23, f"{len(metas)} stripes")
    check(len(store._blocks) == nstripes * code.n, "blocks landed")
    # every local group XORs to zero; parities equal a host re-encode on
    # three column windows of every stripe
    host = NumpyBackend()
    for sid in range(nstripes):
        for grp in code.groups:
            acc = np.zeros(BS, np.uint8)
            for b in grp:
                acc ^= stored(sid, b)
            check(not acc.any(), f"stripe {sid} group {grp[0]} XOR != 0")
        for c0 in (0, int(rng.integers(0, BS - 4096)), BS - 4096):
            cw = np.stack([stored(sid, b)[c0:c0 + 4096]
                           for b in range(code.n)])
            want = host.encode_many(code, cw[None, :code.k])[0]
            check(np.array_equal(cw, want), f"stripe {sid} parity @ {c0}")
    phase("write_stream check", stripes=nstripes, ok=True)

    # 4.2 full read
    t = reset()
    out = codec.read_all(metas)
    report("read_all", t, len(out), {})
    check(np.array_equal(np.frombuffer(out, np.uint8), payload), "read_all")
    del out

    # 4.3 one node lost: degraded read, XOR recovery, rebuild
    node = store.node_of(0, 0)
    store.fail_node(node)
    lost = sorted(store.blocks_on_node(node))
    t = reset()
    got = codec.degraded_read(metas[0], 0, reader_cluster=0)
    report("degraded_read", t, len(got), {"xor_reduce": 1})
    check(np.array_equal(np.frombuffer(got, np.uint8), payload[:BS]),
          "degraded read")
    t = reset()
    rec = codec.recover_blocks(lost, reader_cluster=0)
    counts = report("recover_node", t, len(lost) * BS)
    distinct = len({b for _, b in lost})
    check(counts == {"xor_reduce": distinct},
          f"node recovery launches {counts}, {distinct} plan groups")
    for key in lost:
        check(np.array_equal(np.frombuffer(rec[key], np.uint8), stored(*key)),
              f"recovered {key}")
    t = reset()
    placed = codec.reconstruct_node(node)
    report("reconstruct_node", t, placed * BS, {"xor_reduce": distinct})
    check(placed == len(lost), f"rebuilt {placed} of {len(lost)}")
    check(not store.blocks_on_node(node), "node still holds blocks")
    store.heal_node(node)

    # 4.4 one cluster lost: 21 erasures per stripe, one pattern
    cluster = [store.topo.node_of(0, s) for s in range(24)]
    for nd in cluster:
        store.fail_node(nd)
    pairs = sorted(key for nd in cluster for key in store.blocks_on_node(nd))
    check(len(pairs) == nstripes * 21, f"{len(pairs)} lost pairs")
    t = reset()
    rec = codec.recover_blocks(pairs, reader_cluster=1)
    report("recover_cluster", t, len(pairs) * BS, {"gf_bitmatmul": windows})
    for key in pairs:
        check(np.array_equal(np.frombuffer(rec[key], np.uint8), stored(*key)),
              f"cluster-loss {key}")
    del rec
    for nd in cluster:
        store.heal_node(nd)

    # 4.5 delta-parity updates
    touched = [(0, 5), (11, 100), (22, 179), (22, 3)]
    t = reset()
    for sid, b in touched:
        new = rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
        codec.update_block(metas[sid], b, new)
        check(store.get(sid, b) == new, f"update {sid}/{b}")
    report("update_block", t, len(touched) * BS,
           {"gf_bitmatmul": len(touched)})
    A_cols = torch.from_numpy(gf_bit_columns(code.A)).to(backend.device)
    for sid in sorted({s for s, _ in touched}):
        cw = np.stack([stored(sid, b) for b in range(code.n)])
        data = torch.from_numpy(cw[None, :code.k].copy()).to(backend.device)
        parity = gfk.gf_bitmatmul_plain(A_cols, data)[0].cpu().numpy()
        check(np.array_equal(cw[code.k:], parity), f"updated stripe {sid}")
        want = host.encode_many(code, cw[None, :code.k, :4096])[0]
        check(np.array_equal(cw[:, :4096], want), f"updated stripe {sid} host")
    phase("update check", stripes=len({s for s, _ in touched}), ok=True)


def serve_path(seed: int) -> dict:
    """The serving path: llama3.2-3b at full width, checkpointed as UniLRC
    180-of-210 stripes, restored degraded after a node loss, rebuilt and
    served. Checks every restored byte, the restore's locality, the flash
    launches and the logits; exits on the first failed check. Returns the
    flash kernel's launches and plain calls on the serve run."""
    import torch

    from repro_torch.ckpt import BlockStore, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import make_unilrc
    from repro_torch.io import TorchBackend
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk
    from repro_torch.launch.serve import serve
    from repro_torch.models import (forward, init_params, layers,
                                    pad_cache_to, params_from_jax,
                                    params_to_tree)
    from repro_torch.topo import Topology

    dev = torch.device("cuda")
    cfg = get_config("llama3.2-3b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    phase("serve init", arch=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, q_heads=cfg.num_heads_padded,
          kv_heads=cfg.num_kv_heads_padded, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, params=nparams,
          GB=f"{nparams * 2 / 1e9:.3f}",
          seconds=f"{time.perf_counter() - t0:.2f}")
    check(nparams == 3_388_910_592, f"{nparams} parameters")

    # 6.1 save: the weights as a 180-of-210 checkpoint, 1 MiB blocks
    store = BlockStore(Topology(num_clusters=10, nodes_per_cluster=24))
    mgr = CheckpointManager(store, make_unilrc(2, 10), block_size=MIB,
                            backend=TorchBackend("cuda"))
    tree = params_to_tree(model)
    del model
    gfk.reset_counts()
    xrk.reset_counts()
    t0 = time.perf_counter()
    nstripes = mgr.save(tree, step=0)
    save_s = time.perf_counter() - t0
    ckpt_bytes = 2 * nparams                       # every leaf is bf16
    phase("ckpt save", stripes=nstripes, bytes=ckpt_bytes,
          seconds=f"{save_s:.3f}", GiB_s=f"{ckpt_bytes / GIB / save_s:.3f}",
          gf_launches=gfk.launches, xor_launches=xrk.launches)
    check(nstripes == 36, f"{nstripes} stripes")
    check(sum(m.nbytes for m in mgr.stripes_of(0)) == ckpt_bytes,
          "checkpoint bytes")

    # 6.2 one node lost: degraded restore, cluster-local
    node = store.node_of(0, 0)
    store.fail_node(node)
    gfk.reset_counts()
    xrk.reset_counts()
    t0 = time.perf_counter()
    restored, report = mgr.restore()
    restore_s = time.perf_counter() - t0
    phase("ckpt restore", degraded_blocks=report.degraded_blocks,
          total_blocks=report.total_blocks_read,
          cross_cluster_bytes=report.cross_cluster_bytes,
          inner_cluster_bytes=report.inner_cluster_bytes,
          seconds=f"{restore_s:.3f}",
          GiB_s=f"{ckpt_bytes / GIB / restore_s:.3f}",
          gf_launches=gfk.launches, xor_launches=xrk.launches)
    check(report.degraded_blocks > 0, "restore was not degraded")
    check(report.cross_cluster_bytes == 0, "restore crossed clusters")

    # 6.3 every restored tensor is the saved tensor, byte for byte
    def leaves(node):
        if isinstance(node, dict):
            for key in sorted(node):
                yield from leaves(node[key])
        elif isinstance(node, (tuple, list)):
            for item in node:
                yield from leaves(item)
        else:
            yield node

    nleaves = 0
    for saved, back in zip(leaves(tree), leaves(restored), strict=True):
        check(saved.shape == back.shape and saved.dtype == back.dtype,
              f"restored leaf {nleaves}: {back.shape} {back.dtype}")
        check(torch.equal(saved.view(torch.int16),
                          back.to(dev).view(torch.int16)),
              f"restored leaf {nleaves} differs")
        nleaves += 1
    phase("ckpt bytes", leaves=nleaves, identical=True)
    del tree
    rebuilt = mgr.reconstruct_failures()
    check(not store.failed_nodes and rebuilt > 0, f"rebuilt {rebuilt}")
    model = params_from_jax(cfg, restored, dev)
    del restored, mgr, store
    gc.collect()

    # 6.4 serve: 8 requests, batches of 4, 2048 prompt + 32 generated
    B, P, G, REQ = 4, 2048, 32, 8
    fak.reset_counts()
    torch.cuda.synchronize()
    out = serve(cfg, model, batch=B, requests=REQ, prompt_len=P, gen=G,
                seed=seed, device=dev)
    flash = {"launches": fak.launches, "plain_calls": fak.plain_calls}
    nbatches = math.ceil(REQ / B)
    phase("serve", requests=REQ, batch=B, prompt=P, gen=G,
          seconds=f"{out['seconds']:.3f}",
          tokens_s=f"{out['served_tokens'] / out['seconds']:.1f}",
          generated_tokens_s=f"{REQ * G / out['seconds']:.1f}",
          prefill_ms=",".join(f"{t * 1e3:.2f}" for t in out["prefill_s"]),
          decode_ms_per_token=",".join(f"{t * 1e3 / (G - 1):.3f}"
                                       for t in out["decode_s"]),
          flash=json.dumps(flash))
    check(flash["launches"] == nbatches * cfg.num_layers,
          f"flash launches {flash['launches']} != "
          f"{nbatches} x {cfg.num_layers}")
    check(flash["plain_calls"] == 0, "flash plain version on the serve path")
    for toks in out["tokens"]:
        check(tuple(toks.shape) == (B, G), f"tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "token out of the vocabulary")

    # 6.5 prefill of S-1 tokens + one decode step == prefill of S at the
    # last position, within the reference's bound (tests/test_archs.py)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=rng,
                            device=dev)
    full, _, _ = forward(model, prompts, mode="prefill")
    want = full[:, -1].float()
    del full
    _, cache, _ = forward(model, prompts[:, :P - 1], mode="prefill")
    NSTEP = 4
    cache = pad_cache_to(cache, cfg, P + 2 * NSTEP)
    step, _, _ = forward(model, prompts[:, P - 1:], mode="decode",
                         cache=cache, pos=P - 1)
    got = step[:, 0].float()
    finite = bool(torch.isfinite(want).all() and torch.isfinite(got).all())
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    phase("serve check", max_abs_logit=f"{scale:.4f}",
          decode_vs_prefill=f"{rel:.5f}", bound=0.05, finite=finite)
    check(finite, "non-finite logits")
    check(rel < 0.05, f"decode vs prefill {rel:.4f} of max |logit|")

    # 6.6 where a decode step's time goes: host clock over NSTEP steps,
    # then the device time of NSTEP more from torch.profiler
    tok = step[:, 0].argmax(dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(NSTEP):
        forward(model, tok, mode="decode", cache=cache, pos=P + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / NSTEP
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(NSTEP, 2 * NSTEP):
                forward(model, tok, mode="decode", cache=cache, pos=P + i)
            torch.cuda.synchronize()
        # device-side events only (kernels, copies), as the profiler's own
        # table totals them: a CPU op's self device time repeats them
        ops = [(e.key, e.self_device_time_total / 1e3 / NSTEP, e.count)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
        device_ms = sum(ms for _, ms, _ in ops)
        top = sorted(ops, key=lambda o: -o[1])[:4]
        phase("decode split", step_ms=f"{step_ms:.3f}",
              device_ms=f"{device_ms:.3f}",
              device_share=f"{device_ms / step_ms:.4f}",
              device_ops_per_step=sum(c for _, _, c in ops) // NSTEP,
              top=json.dumps([(k[:40], round(ms, 4)) for k, ms, _ in top]))
    except RuntimeError as err:         # the profiler is untried there
        phase("decode split", step_ms=f"{step_ms:.3f}",
              device_ms="not measured", profiler_error=repr(str(err)[:200]))
    del cache

    # 6.7 the flash kernel's share of one prefill, from CUDA events
    events = []
    kernel_flash = layers.flash_attention

    def timed_flash(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        y = kernel_flash(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return y

    layers.flash_attention = timed_flash
    try:
        p0 = torch.cuda.Event(enable_timing=True)
        p1 = torch.cuda.Event(enable_timing=True)
        p0.record()
        forward(model, prompts, mode="prefill")
        p1.record()
        p1.synchronize()
    finally:
        layers.flash_attention = kernel_flash
    prefill_ms = p0.elapsed_time(p1)
    flash_ms = sum(a.elapsed_time(b) for a, b in events)
    phase("prefill split", prefill_ms=f"{prefill_ms:.3f}",
          flash_ms=f"{flash_ms:.3f}", flash_calls=len(events),
          flash_share=f"{flash_ms / prefill_ms:.4f}")
    return flash


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repo root")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    # fp32 products in full fp32 (the plain versions' reference arithmetic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment ---------------------------------------------------------
    smi = shutil.which("nvidia-smi")
    card_line = run([smi, "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0] if smi \
        else "nvidia-smi not found"
    from repro_torch.kernels import _build
    nvcc = run([_build._nvcc(), "--version"]).splitlines()[-1]
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=repr(nvcc), device=repr(torch.cuda.get_device_name(0)),
          card=repr(card_line))

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{_build.build_seconds:.2f}",
          library=_build.library_path().name)
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "warning",
                                   "Function properties")):
            print("  ptxas:", line.strip())
    for kernel, want in (("flash_fwd_sm90_kernel", 2),     # d = 64, 128
                         ("gf_matmul_sm90_kernel", 5)):    # N widths
        spills = ptxas_spills(_build.build_log, kernel)
        phase(f"ptxas {kernel}", functions=len(spills),
              spill_bytes=sum(spills.values()))
        check(len(spills) == want, f"ptxas reported {len(spills)} "
              f"instantiations of {kernel}, want {want}")
        check(not any(spills.values()), f"{kernel} spills {spills}")

    from repro_torch.core import decode_plan_cached, make_unilrc
    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.io import TorchBackend
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2505)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    code = make_unilrc(alpha=2, z=10)
    check((code.n, code.k, code.meta["r"]) == (210, 180, 20), code.name)
    S_WIN, BS = 8, MIB
    cluster_plan = decode_plan_cached(code, code.groups[0])

    # 3. kernels against their plain versions at the main path's shapes -----
    def gf_case(M, S, B, reps=10, plain_reps=2, offset=0):
        m, k = M.shape
        cols = torch.from_numpy(gf_bit_columns(M)).to(dev)
        if offset:
            data = rand(S * k * B + offset)[offset:].view(S, k, B)
        else:
            data = rand(S, k, B)
        got = gfk.gf_bitmatmul(cols, data)
        want = gfk.gf_bitmatmul_plain(cols, data)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"gf_bitmatmul != plain at S={S} m={m} k={k} B={B}")
        ms = time_ms(lambda: gfk.gf_bitmatmul(cols, data), reps)
        pms = time_ms(lambda: gfk.gf_bitmatmul_plain(cols, data), plain_reps)
        b, by = bound_ms(gfk.bound_bytes(S, m, k, B),
                         gfk.bound_ops(S, m, k, B))
        phase("kernel gf_bitmatmul", S=S, m=m, k=k, B=B, offset=offset,
              max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{pms:.3f}",
              bound_ms=f"{b:.4f}", bound_by=by, bound_share=f"{b / ms:.4f}",
              pass_bytes=gfk.pass_bytes(S, m, k, B),
              TOP_s=f"{gfk.bound_ops(S, m, k, B) / (ms / 1e3) / 1e12:.1f}",
              GiB_s=f"{S * k * B / GIB / (ms / 1e3):.2f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, bound_share=b / ms)

    def xor_case(S, s, B, reps=10, plain_reps=3, offset=0):
        if offset:
            blocks = rand(S * s * B + offset)[offset:].view(S, s, B)
        else:
            blocks = rand(S, s, B)
        got = xrk.xor_reduce(blocks)
        want = xrk.xor_reduce_plain(blocks)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"xor_reduce != plain at S={S} s={s} B={B}")
        ms = time_ms(lambda: xrk.xor_reduce(blocks), reps)
        pms = time_ms(lambda: xrk.xor_reduce_plain(blocks), plain_reps)
        b, by = bound_ms(xrk.bound_bytes(S, s, B))
        phase("kernel xor_reduce", S=S, s=s, B=B, offset=offset,
              max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{pms:.3f}",
              bound_ms=f"{b:.4f}", bound_by=by,
              GiB_s=f"{xrk.bound_bytes(S, s, B) / GIB / (ms / 1e3):.2f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, bound_share=b / ms)

    def flash_case(B, Hq, Hkv, Sq, Skv, d, dtype, causal, window=0,
                   reps=30, plain_reps=2):
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
                   for sh in ((B, Hq, Sq, d), (B, Hkv, Skv, d),
                              (B, Hkv, Skv, d)))

        def kernel():
            return fak.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)

        def plain():
            return fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                 window=window)
        out, lse = kernel()
        want, want_lse = plain()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        dead = torch.isneginf(lse) & torch.isneginf(want_lse)
        lse_err = torch.where(dead, 0.0, (lse - want_lse).abs()).max().item()
        bf16 = dtype == torch.bfloat16
        tol, lse_tol = (2e-2, 2e-2) if bf16 else (2e-5, 1e-4)
        shape = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} d={d} "
                 f"{dtype} causal={causal} window={window}")
        check(err <= tol and lse_err <= lse_tol,
              f"flash_attention != plain at {shape}: out {err}, lse {lse_err}")
        mask = None
        if window:
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Skv, device=dev)[None]
            mask = qp - kp < window
            if causal:
                mask &= qp >= kp

        def library():      # timed as a yardstick only, never on the path
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        ms = time_ms(kernel, reps)
        pms = time_ms(plain, plain_reps)
        lms = time_ms(library, reps)
        ops = fak.bound_flops(B, Hq, Sq, Skv, d, d, causal=causal,
                              window=window)
        b, by = bound_ms(
            fak.bound_bytes(B, Hq, Hkv, Sq, Skv, d, d, q.element_size()),
            ops, BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S)
        phase("kernel flash_attention", B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
              d=d, dtype=str(dtype).replace("torch.", ""), causal=causal,
              window=window, max_abs_err=f"{err:.3e}",
              lse_max_abs_err=f"{lse_err:.3e}", ms=f"{ms:.4f}",
              plain_ms=f"{pms:.3f}", library_ms=f"{lms:.4f}",
              bound_ms=f"{b:.4f}", bound_by=by,
              bound_share=f"{b / ms:.4f}", vs_library=f"{ms / lms:.3f}",
              TFLOP_s=f"{ops / (ms / 1e3) / 1e12:.1f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, bound_share=b / ms, library_ms=lms)

    rng = np.random.default_rng(2505)
    # a broken mbarrier ring would hang the card (the gf and flash kernels
    # have no timeout of their own): end the process with a traceback
    # instead of waiting
    faulthandler.dump_traceback_later(300, exit=True)
    gf_main = gf_case(code.A, S_WIN, BS)                       # encode
    gf_case(cluster_plan.M, S_WIN, BS)                         # decode, N=176
    for rows, u in ((21, 1), (42, 2), (105, 5)):               # delta terms
        gf_case(rng.integers(1, 256, (rows, u), dtype=np.uint8), 1, BS,
                plain_reps=3)
    gf_case(code.A, 2, 4096)                                   # two passes
    gf_case(rng.integers(0, 256, (1, 20), dtype=np.uint8), 3, 3000)
    gf_case(rng.integers(1, 256, (1, 1), dtype=np.uint8), 2, 1000)  # K pad
    gf_case(code.A, 2, 4097, offset=1)                         # ragged
    gf_case(code.A, 36, 256)                                   # save batch
    faulthandler.cancel_dump_traceback_later()
    xor_main = xor_case(23, 20, BS)                            # recovery
    xor_case(1, 2, 3001)
    xor_case(4, 29, 4097, offset=3)
    bf16, fp32 = torch.bfloat16, torch.float32
    faulthandler.dump_traceback_later(300, exit=True)
    flash_main = flash_case(4, 32, 8, 2048, 2048, 128, bf16, True)  # prefill
    flash_case(4, 32, 8, 2047, 2047, 128, bf16, True)      # tile edge - 1
    flash_case(4, 32, 8, 2049, 2049, 128, bf16, True)      # tile edge + 1
    flash_case(4, 32, 8, 2048, 2048, 128, bf16, True, window=512)
    flash_case(1, 32, 8, 1024, 2048, 128, bf16, False)     # Sq != Skv
    flash_case(4, 32, 8, 1000, 1000, 128, bf16, True)      # ragged
    flash_case(2, 16, 4, 1024, 1024, 64, bf16, True)       # d = 64
    flash_case(1, 8, 2, 1024, 1024, 128, fp32, True, reps=5)
    faulthandler.cancel_dump_traceback_later()

    # 4. main path ------------------------------------------------------------
    t0 = time.perf_counter()
    payload = rand(4 * GIB).cpu().numpy()
    phase("payload", bytes=payload.size,
          seconds=f"{time.perf_counter() - t0:.2f}")
    gfk.reset_counts()
    xrk.reset_counts()
    main_path(TorchBackend("cuda"), MIB, payload, rng)
    launches = {"gf_bitmatmul": gfk.launches, "xor_reduce": xrk.launches}
    plain = {"gf_bitmatmul": gfk.plain_calls, "xor_reduce": xrk.plain_calls}
    phase("main path", kernel_launches=json.dumps(launches),
          plain_calls=json.dumps(plain))
    check(all(v > 0 for v in launches.values()), "a kernel never launched")
    check(not any(plain.values()), "a plain version ran on the main path")
    del payload
    gc.collect()

    # 6. serve path -------------------------------------------------------------
    flash = serve_path(2505)

    # 5. results ----------------------------------------------------------------
    kernels = [
        dict(name="gf_bitmatmul", kernel="gf_matmul_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/gf_matmul_sm90.cu",
             replaces="src/repro/kernels/gf_bitmatmul.py:108",
             launches=launches["gf_bitmatmul"], library_ms=None, **gf_main),
        dict(name="xor_reduce", kernel="xor_fold_kernel", route="cuda",
             source="src/repro_torch/csrc/coding_kernels.cu",
             replaces="src/repro/kernels/xor_reduce.py:54",
             launches=launches["xor_reduce"], library_ms=None, **xor_main),
        dict(name="flash_attention", kernel="flash_fwd_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/flash_fwd_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=flash["launches"], **flash_main),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
