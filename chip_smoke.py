#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

Drives the port's main path on one CUDA card and checks every byte:

  1. environment: torch, CUDA and nvcc versions, the card's name and
     power limit;
  2. build: the CUDA kernels from `src/repro_torch/csrc/`, compiled by
     nvcc into `build/repro_torch/` at first use;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes and its edges (byte equality for the coding
     kernels, whose launch plan `kernels.autotune.matmul_plan` must equal
     the one the kernel's host code makes, `repro_gf_plan`: threads, grid,
     shared memory, K passes, N width; 2e-2 in bf16 and 2e-5 / 1e-4 in
     fp32 for attention, at head
     dims 64, 128 and 256: recurrentgemma's windowed MQA prefill and the
     64-key tile's edges; minicpm3's MLA prefill in the per-head form
     (48 heads, G = 1, q and k zero past 96, v past 64, as
     `layers._mla_heads` pads them to 128), with the padded bound and the
     published one (40 heads at 96 / 64); Kimi K2's MLA prefill at the
     benchmark cell's shape (B 8, 64 heads, S 4,096, q and k zero past
     192 and v past 128, padded to 256), with the padded bound and the
     published one (64 heads at 192 / 128); llama-3.2-vision's cross-attention, not
     causal, over 6,404 keys at Sq 2,048 and Sq 1, to `CROSS_TOLS`,
     which the plain version over an unmasked key tail must fail; fp32,
     on the tensor
     cores as 3xTF32, at the llama and recurrentgemma prefill shapes, d =
     64 and a small GQA shape), with its median time over CUDA events, the plain version's
     time, the bound and bound share (fp32: three TF32 products per
     product at the TF32 rate) and, for attention, PyTorch's
     `scaled_dot_product_attention` as a yardstick; ptxas must report 0
     spill bytes for every instantiation of the three sm90 kernels (three
     of each flash kernel, five of the coding kernel), the fp32 flash
     kernel's SASS must hold TF32 HMMAs at each head dim, and one fp32
     call of the model layer's `flash_attention` must launch it once;
     the layer's gradient (kernel forward, blockwise PyTorch backward)
     against the same backward from the plain forward at the train shape
     and against fp32 autograd through naive attention (2e-2 of max
     |grad|), with the backward's time beside the forward kernel's and
     SDPA's forward + backward;
  3b. the launch planner (`kernels.autotune`, ROADMAP A5): at the encode
     shape (S=8, 30 x 180, 1 MiB) and the delta terms (21 x 1, 1 MiB)
     `measure_matmul_tiles` times every candidate grid on the card (SMs x
     c for c up to the CTAs an SM holds at once: one at 168 registers a
     thread, so the default alone) and the winners go to a timings file
     under `build/`; with
     `REPRO_TORCH_AUTOTUNE_CACHE` naming it (and a hand-written XOR entry,
     half the default grid, for S=23, s=20, 1 MiB) both shapes launch
     again through `kernels.ops`: the plan must be "measured", the host
     code's own plan for that grid must equal it, every byte must equal
     the plain version's; each candidate's, the default's and the
     measured plan's device ms and bound shares are printed. The variable
     is unset before phase 4, so every later phase launches the default
     plan. Then the hazards CLI (`python -m repro_torch.analysis.hazards`)
     on the card: every workload OK with the CPU's ops, waves and
     violations;
  4. stripe path: UniLRC 180-of-210 (alpha=2, z=10) on 10 clusters x 24
     nodes, 1 MiB blocks, `TorchBackend("cuda")`: a 4 GiB streamed write
     in windows of 8 stripes, a full read, one node lost (degraded read,
     recovery, rebuild), one cluster lost (21 erasures per stripe) and a
     few delta-parity updates; launch bounds asserted;
  7. serving front-end on the stripe path's 23 stripes: a 4-shard
     `ShardedFrontend` on the same `TorchBackend("cuda")`, driven open loop
     by the reference saturation benchmark's traffic (Zipf 0.9 over the
     stripes, tenants gold / silver / free at 0.5 / 0.3 / 0.2, 8,000
     requests/s for 0.15 s of virtual time in 2 ms ticks, one node failed,
     a metered BACKGROUND rebuild storm of its parity blocks every 8 ticks,
     QoS watermarks and tenant buckets, a hot-block cache, every flush
     hazard-checked); then a scrub of every stripe, a same-block
     degraded-read storm cached and uncached, and degraded reads after a
     whole cluster is lost. Every served byte is checked against the
     payload; wall latencies per class, requests/s, launches per class,
     the cache hit rate and the device share are printed, and the pinned
     host memory the phase used (the backend's staging is bounded per
     thread). The phase then hands back the device memory it left cached;
  6. serve path: llama3.2-3b at full width (random weights from a seed)
     saved as a 180-of-210 checkpoint through `CheckpointManager`, one
     node lost, restored degraded (zero cross-cluster bytes, every tensor
     byte-identical), rebuilt, and served: 8 requests of 2048 prompt + 32
     generated tokens in batches of 4, every prefill attention layer
     through the flash kernel (no blockwise attention); prefill + decode
     checked against prefill; a prefill's host time beside its device
     time (torch.profiler) printed, as in every served phase;
  8. the server's own entry point at its SMOKE config (head dim 16, which
     no flash kernel takes): `repro_torch.launch.serve.run` completes on
     the card, attending blockwise with no flash launch;
  9. recurrentgemma-9b at full width (38 layers: 12 x (rg, rg,
     local_attn) + (rg, rg); 10.5 B parameters, 21.1 GB with fp32 `lam`
     leaves) through the same path as phase 6: saved as 112 stripes in
     windows of 8, one node lost, restored degraded byte for byte with
     zero cross-cluster bytes, rebuilt, then 4 requests of 3,968 prompt +
     32 generated tokens in batches of 2, every prefill local-attention
     layer through the flash kernel at head dim 256, window 2,048 (24
     launches, no blockwise or plain call); prefill + decode checked
     against prefill; prefill, flash and decode times and the peak host
     memory printed;
 10. the failure/repair simulator (`repro_torch.sim`) on the card, after
     phase 9 has let go of its model and store: (a) the §5 Markov chain
     event by event for UniLRC and ALRC 30-of-42, 400 trials, lifetimes
     drawn on the card, the Markov answer within 3.29 standard errors;
     (b) a correlated campaign in metadata mode, UniLRC 180-of-210 on
     10 x 24 nodes with link-charged repair and cluster losses; (c) a
     data-path trial on that deployment without cluster losses: 23
     stripes of 1 MiB blocks (4 GiB of payload) under 500 h of node
     churn, every repair a front-end rebuild launching the coding
     kernels, launches == plan groups == the kernels' own counts, no
     data lost and the payload read back byte for byte; (d) two data
     blocks of local group 0 dropped in all 23 stripes and healed by a
     data-path scheduler in one pattern decode and one XOR;
 11. training (`repro_torch.train`) at llama3.2-3b's full width, cut to 8
     of its 28 layers (a 17.5 GB train state): 8 x 2048 tokens a step in
     2 microbatches with remat, steps 0-2, a UniLRC 180-of-210 checkpoint
     of the train state (phase 4's deployment, 93 stripes), step 3, one
     node lost, a degraded restore (zero cross-cluster bytes, every leaf
     byte-identical), the rebuild, step 3 replayed from the restored
     state (loss within 1e-3) and step 4; 32 flash launches a step (8
     layers x 2 microbatches x forward and recompute), step times and
     their split, mfu, peak device memory and host VmRSS printed, and
     the loss on a held-out batch before and after; (b) a witness at the
     same full width cut to 2 layers and 2 x 256 tokens: three steps of
     the same settings from one state on the card and on the CPU, loss
     and grad norm within 2e-2 relative, the first step's gradient leaf
     by leaf within 2e-2 of each leaf's max |m|; (c) (a)'s model, state
     and batches at a tenth of the learning rate, whose held-out loss
     must fall;
 12. the training entry point `repro_torch.launch.train.run` at its SMOKE
     config (head dim 16: blockwise attention, no flash launch), the
     verify recipe's checkpoint and node-loss drill;
 11d. phase 11b's witness for MLA: minicpm3-4b at full width cut to 2
     layers, three steps on the card and on the CPU from one state, the
     same bounds but m's, 3e-2 (`WITNESS_M_BOUND`); MLA attends in
     the per-head form (96 / 64 padded to 128: the flash kernel on the
     card, its plain version on the CPU);
 13. minicpm3-4b, the server's default arch, at full width (62 MLA
     layers, 4.40 B parameters, 8.79 GB) through phase 6's path: saved as
     47 stripes in windows of 8, one node lost, restored degraded byte
     for byte with zero cross-cluster bytes, rebuilt, 8 requests of 2048
     + 32 tokens in batches of 4; every prefill attention layer in the
     per-head form on the flash kernel (96 / 64 padded to 128: 124
     launches, nothing blockwise); decode on the absorbed latent cache
     checked against prefill;
 14. phi3.5-moe at full width cut to 4 of its 32 layers (the 32-layer
     model's 83.7 GB do not fit the card): 5.46 B parameters, 10.93 GB
     with the fp32 routers, 58 stripes, the same drill and traffic; the
     MoE FFN (top 2 of 16 experts, capacity 1.25) beside attention
     through the flash kernel at head dim 128 (8 launches); decode
     against prefill in fp32 and, per sequence, on the bf16 weights at
     full-row capacity, a sequence exempt only where its routing
     switched at a near tie (`routing_switches`);
 14b. Kimi K2 Instruct as one rank of 32-way expert parallelism
     (`kimi-k2-instruct-ep32`) at full width cut to 4 of its 60 `mla_moe`
     layers: 5.05 B parameters (experts 0-11 of 384, the fp32 routers
     and correction biases), 10.13 GB, 54 stripes, the same drill and
     traffic; every prefill attention layer in the per-head form on the
     flash kernel at head dim 256 (192 / 128 padded: 8 launches, 8
     per-head calls), the sigmoid-routed dropless MoE beside it; decode
     (absorbed, YaRN) against prefill in fp32, the bf16 difference
     printed;
 15. rwkv6-7b at full width (32 `rwkv` layers, 64 wkv heads of 64; 7.52 B
     parameters, 15.04 GB with fp32 `decay_base` / `bonus` leaves) through
     the same drill: 80 stripes in windows of 8, restored degraded byte
     for byte with zero cross-cluster bytes, rebuilt, the llama cell's
     traffic; no attention anywhere (no flash launch, no blockwise call):
     the chunked WKV scan in fp32 (TF32 off), 64 chunks a layer; decode,
     the exact one-step recurrence, against a prefill of 2,047 tokens
     (23-token chunks);
 16. llama-3.2-vision-11b at full width (8 x (4 attn + 1 cross_attn), 32
     / 8 heads at 128; 9.78 B parameters, 19.55 GB, 104 stripes), its
     gates drawn from U(0.3, 0.9) before the save so that they go through
     the checkpoint and the decode check sees the cross-attention; each
     batch a (4, 6404, 4096) bf16 stub vision input; 8 requests of
     2,048 + 32 tokens in batches of 4; every attention through the flash
     kernel: 40 launches a prefill batch (32 causal, 8 not causal over
     6,404 vision keys) and 8 a decode step (Sq 1), none plain or
     blockwise; decode (the vision keys read unpadded from the cache,
     ROADMAP C3) against prefill within 5e-2;
 17. hubert-xlarge at full width (48 layers, d 1280, 16 heads at 80,
     embedding-free, not causal; 1.26 B parameters, 2.52 GB, 14 stripes)
     through the drill, then the reference's `encode` cell: 8 sequences
     of 2,048 seeded frame embeddings, 4 at a time (48 blockwise calls a
     batch: head dim 80 takes no kernel), each sequence alone against its
     row of the batch, and a card-vs-CPU witness at the same width cut to
     2 layers on 1 x 512 frames, both within 5e-2 of max |logit|;
     then the example programs on the card: `examples/serving_torch.py`
     and `examples/train_with_failures_torch.py` at their defaults, each
     to its own OK line;
 18. the mesh (`mesh_phase`): phase 11's training shape on the card's
     host mesh, (data 1, model 1), the state placed by
     `launch.train.shard_state`, seq_parallel on, two steps whose losses
     and every leaf equal the same steps without a mesh bit for bit;
     `elastic_remesh` onto ("data",) (every leaf byte-identical, a third
     step equal); the training CLI's drill and the serving CLI on the
     mesh (`--mesh`: without it one device runs them unsharded, as
     phases 8, 12 and 17 do; the served tokens equal the unsharded
     server's); and four
     dry-run cells on 256 / 512 fake devices in child processes
     (llama3.2-3b x train_4k x single, kimi-k2 x decode_32k x multi,
     rwkv6-7b x long_500k x single, and hubert-xlarge x prefill_32k x
     single, whose blockwise attention traces as one operator a layer:
     48, ROADMAP C4), their per-device bytes beside the card's 80 GB. Phase 3 also times each flash case through the
     operator `torch.ops.repro_torch.flash_attention_fwd` (`op_ms`,
     `dispatch_us`: what the dispatcher adds, which the wrapper skips);
  5. a JSON line of per-kernel numbers (five rows: gf, xor, flash d=128,
     flash d=256, and the fp32 flash kernel at d = 64, 128 and 256, which
     no serve path runs; gf, xor and flash d=128 count their launches per
     path, the simulator's, training's, phases 13-17's and the training
     example's included; the flash d=128 row carries phase 16's two
     cross-attention shapes under `cross_shapes`, each with its
     launches as the wrapper counted them by mode, its error and the
     unmasked tail's, times and bound; the gf and xor rows carry phase
     3b's plan: `plan_source`, `grid_steps`, `tuned_device_ms`), the card
     line, and the result line
     `{"ok": true, "device": {...}}` last.

Any failed check exits non-zero before the result line. Without a CUDA
device, or without the repo's `src/repro_torch` beside it, it exits 1.

Run from the root of the repo:  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import faulthandler
import gc
import json
import math
import pathlib
import re
import resource
import shutil
import statistics
import subprocess
import os
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12            # H100 SXM dense TF32 tensor-core rate
GIB = 1 << 30
MIB = 1 << 20
# phase 3's bounds on out and lse at the cross-attention shapes (not
# causal over 6,404 unit-normal keys): each output averages ~2,400
# effective keys, so |out| ~ 0.02 and the bf16 cases' 2e-2 would pass
# anything. Measured on an H100: 4.9e-4 and 9.5e-6. A kernel that left the
# 124 padded keys of the last 128-key tile unmasked (each scores 0) would
# move lse by log(1 + 124 / 10,560) ~ 1.2e-2: the case checks that the
# plain version computed so fails these bounds
CROSS_TOLS = (2e-3, 1e-3)
# device clock cycles of spin queued ahead of a call timed for its device
# time alone (~1 ms at the H100's 1,980 MHz): more than the host takes to
# enqueue a wrapper
SPIN_CYCLES = 2_000_000


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


def time_ms(fn, reps: int, spin: bool = False) -> float:
    """Median time of `fn()` in ms, one CUDA-event pair per call. By
    default the device waits for the host between the events, so the time
    is per call: the wrapper's host time (checks, allocation, the ctypes
    call) counts where it exceeds the device's. With `spin` each call is
    queued behind ~1 ms of device spin (`torch.cuda._sleep`), so the host
    has enqueued both events and the call's launches before the device
    reaches the first event: device time only (`device_ms`)."""
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


def sass_opcodes(library: pathlib.Path, kernel: str,
                 nvcc: str) -> dict[str, dict[str, int]]:
    """Opcode counts in the SASS of each function of `library` whose
    mangled name contains `kernel` (`cuobjdump -sass`, found beside
    nvcc)."""
    tool = pathlib.Path(nvcc).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    ops = None
    for line in text.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            ops = counts.setdefault(func.group(1), {}) \
                if kernel in func.group(1) else None
            continue
        inst = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)", line)
        if inst and ops is not None:
            ops[inst.group(1)] = ops.get(inst.group(1), 0) + 1
    return counts


def tf32_hmma(ops: dict[str, int]) -> int:
    """Tensor-core MMA instructions with a TF32 type among `ops`."""
    return sum(n for op, n in ops.items()
               if op.startswith("HMMA") and "TF32" in op)


def main_path(backend, BS: int, payload, rng):
    """The port's main path: UniLRC 180-of-210 on 10 x 24 nodes through
    `backend`, windows of 8 stripes. Checks every byte and the launch
    bounds; exits on the first failed check. Returns the codec, the stripe
    metadata and the new bytes of the data blocks it updated."""
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
    updated = {}
    t = reset()
    for sid, b in touched:
        new = rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
        codec.update_block(metas[sid], b, new)
        check(store.get(sid, b) == new, f"update {sid}/{b}")
        updated[(sid, b)] = new
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
    del store.put_many, store.get_many          # the timing wrappers
    return codec, metas, updated


def frontend_path(codec, metas, payload, updated: dict, seed: int) -> dict:
    """The serving front-end on the stripe path's stripes: a 4-shard
    `ShardedFrontend` over `codec` (its `TorchBackend("cuda")` shared by
    the shards), driven by the reference saturation benchmark's traffic
    (`benchmarks/fig_saturation.py`: Zipf 0.9, three tenants, 8,000
    requests/s for 0.15 s of virtual time in 2 ms ticks, one node failed,
    a BACKGROUND rebuild storm of its parity blocks every 8 ticks metered
    at 4 blocks per shard flush, QoS, a hot-block cache of 4 x stripes,
    analysed flushes); then a scrub, a same-block degraded-read storm
    cached and uncached, and degraded reads after a cluster loss. The
    front-end stamps latencies with the wall clock; virtual time only
    paces the open loop's ticks and the tenant buckets. Checks
    every served byte against `payload` (with `updated` applied) right
    after the flush that served it, before the next tick's submits, and
    takes the checking time out of the latencies; exits on the first
    failed check. Returns the phase's launches per kernel."""
    import numpy as np
    import torch

    from repro_torch.io import (HotBlockCache, Priority, ShardedFrontend,
                                VirtualClock, ZipfWorkload, drive_open_loop)
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk
    from repro_torch.priority import AdmissionController, QoSConfig

    store, code, backend = codec.store, codec.code, codec.backend
    k, BS, SHARDS = code.k, codec.block_size, 4
    for (sid, b), new in updated.items():          # the phase-4 updates
        off = (sid * k + b) * BS
        if off < payload.size:
            n = min(BS, payload.size - off)
            payload[off:off + n] = np.frombuffer(new, np.uint8)[:n]

    def want_block(sid, b):
        if (sid, b) in updated:
            return np.frombuffer(updated[(sid, b)], np.uint8)
        off = (sid * k + b) * BS
        out = np.zeros(BS, np.uint8)
        part = payload[off:off + BS]
        out[:part.size] = part
        return out

    def check_read(sid, block, data):
        got = np.frombuffer(data, np.uint8)
        if block is not None:
            check(np.array_equal(got, want_block(sid, block)),
                  f"degraded read {sid}/{block}")
            return
        start = sid * k * BS
        check(got.size == metas[sid].nbytes and np.array_equal(
            got, payload[start:start + got.size]), f"client read {sid}")

    def pct_ms(lat, q):
        if not lat:
            return "none"
        lat = sorted(lat)
        return f"{lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3:.3f}"

    def sync():
        torch.cuda.synchronize()

    gfk.reset_counts()
    xrk.reset_counts()
    backend.reset_times()

    # 7.1 open loop under one failed node and a rebuild storm
    failed = store.node_of(metas[0].stripe_id, 0)
    held = store.blocks_on_node(failed)
    lost_data = {s: b for s, b in held if b < k}
    parity = sorted((s, b) for s, b in held if b >= k)
    check(bool(lost_data) and bool(parity), f"node {failed} holds {held}")
    store.fail_node(failed)
    ticks = [VirtualClock() for _ in range(SHARDS)]
    admission = AdmissionController(
        QoSConfig(background_watermark=64, degraded_watermark=256,
                  tenant_rate=90_000.0, tenant_burst=3_000.0,
                  deadline_s={Priority.CLIENT_READ: 0.004}),
        clock=ticks[0])
    cache = HotBlockCache(capacity_blocks=4 * len(metas))
    fe = ShardedFrontend(codec, num_shards=SHARDS, background_ops_per_flush=4,
                         cache=cache, admission=admission,
                         clock=time.perf_counter, analyze_flushes=True)
    duration = 0.15
    arrivals = ZipfWorkload(num_stripes=len(metas), rate_rps=8_000,
                            duration_s=duration, theta=0.9,
                            tenants=("gold", "silver", "free"),
                            tenant_weights=(0.5, 0.3, 0.2),
                            seed=seed).arrivals()
    submitted = {p: 0 for p in Priority}
    waiting, lat = [], {p: [] for p in Priority}
    served = {"bytes": 0, "shed": 0, "rebuilt": 0}
    # host seconds serving (the front-end's flushes) and checking results
    split = {"flush_s": 0.0, "check_s": 0.0}
    flush = fe.flush

    def timed_flush():
        t0 = time.perf_counter()
        out = flush()
        split["flush_s"] += time.perf_counter() - t0
        harvest()
        return out
    fe.flush = timed_flush

    def track(handle, sid, block):
        waiting.append((handle, sid, block, split["check_s"]))
        children = getattr(handle, "_children", [handle])
        submitted[handle.priority] += len(children)
        return handle

    def harvest():
        """Check what the last flush served. A request that waited over
        several flushes had earlier checks run while it waited: they are
        the smoke's own time, not the front-end's, and leave its latency."""
        t0 = time.perf_counter()
        checked_before = split["check_s"]
        still = []
        for handle, sid, block, check_at_submit in waiting:
            if not handle.done:
                still.append((handle, sid, block, check_at_submit))
                continue
            if handle.shed:
                served["shed"] += 1
                continue
            value = handle.result()
            lat[handle.priority].append(
                handle.latency_s - (checked_before - check_at_submit))
            if handle.kind == "rebuild":
                served["rebuilt"] += value[0]
                continue
            served["bytes"] += len(value)
            check_read(sid, block, value)
        waiting[:] = still
        split["check_s"] += time.perf_counter() - t0

    def submit(a):
        meta = metas[a.stripe]
        if a.stripe in lost_data:
            return track(fe.submit_degraded_read(
                meta, lost_data[a.stripe], tenant=a.tenant),
                a.stripe, lost_data[a.stripe])
        return track(fe.submit_client_read(meta, tenant=a.tenant),
                     a.stripe, None)

    tick_no = [0]

    def on_tick(t):
        tick_no[0] += 1
        if t > duration or tick_no[0] % 8:
            return None
        for s, b in parity:
            store.drop_block(s, b)
        handle = track(fe.submit_rebuild(parity, exclude_node=failed),
                       None, None)
        return [(handle, t, parity[0][0] % SHARDS)]

    sync()
    t0 = time.perf_counter()
    drive_open_loop(fe, arrivals, submit, clocks=ticks, num_shards=SHARDS,
                    tick_s=0.002, on_tick=on_tick)
    sync()
    wall = time.perf_counter() - t0
    harvest()
    check(not waiting, f"{len(waiting)} requests never resolved")
    stats = fe.stats
    t = backend.take_times()
    for p in Priority:
        check(stats[p].requests + stats[p].shed_requests == submitted[p],
              f"{p.name}: {stats[p].requests} served + "
              f"{stats[p].shed_requests} shed != {submitted[p]} submitted")
        check(stats[p].failed_requests == 0, f"{p.name} requests failed")
    hazard_flushes = fe.hazard_checked_flushes
    check(hazard_flushes > 0, "no flush was hazard-checked")
    requests = sum(stats[p].requests for p in Priority)
    phase("frontend open loop", arrivals=len(arrivals),
          virtual_s=duration, wall_s=f"{wall:.3f}",
          requests=requests, requests_s=f"{requests / wall:.1f}",
          requests_s_without_checks=(
              f"{requests / (wall - split['check_s']):.1f}"),
          flush_s=f"{split['flush_s']:.3f}",
          check_s=f"{split['check_s']:.3f}",
          requests_per_flush_s=f"{requests / split['flush_s']:.1f}",
          served_GiB=f"{served['bytes'] / GIB:.3f}",
          GiB_s=f"{served['bytes'] / GIB / wall:.3f}",
          shed=served["shed"], rebuilt_blocks=served["rebuilt"],
          hazard_checked_flushes=hazard_flushes,
          cache_hit_rate=f"{cache.stats.hit_rate:.4f}",
          device_share=f"{t['kernel_ms'] / 1e3 / wall:.5f}",
          kernel_ms=f"{t['kernel_ms']:.1f}", h2d_ms=f"{t['h2d_ms']:.1f}",
          d2h_ms=f"{t['d2h_ms']:.1f}")
    for p in Priority:
        cls = stats[p]
        phase(f"frontend class {p.name}", submitted=submitted[p],
              served=cls.requests, shed=cls.shed_requests,
              p50_wall_ms=pct_ms(lat[p], 0.50),
              p99_wall_ms=pct_ms(lat[p], 0.99),
              max_wall_ms=pct_ms(lat[p], 1.0),
              launches=cls.launches, blocks=cls.blocks,
              cache_hits=cls.cache_hits,
              deadline_misses=cls.deadline_misses, flushes=cls.flushes)
    fe.close()
    store.heal_node(failed)

    # 7.2 scrub every stripe (re-encode: gf_bitmatmul)
    fe = ShardedFrontend(codec, num_shards=SHARDS, analyze_flushes=True)
    backend.reset_times()
    t0 = time.perf_counter()
    report = fe.submit_scrub(metas)
    fe.drain()
    wall = time.perf_counter() - t0
    report = report.result()
    t = backend.take_times()
    scrub_launches = fe.stats[Priority.BACKGROUND].launches
    phase("frontend scrub", stripes=report.stripes, checked=report.checked,
          mismatched=len(report.mismatched), wall_s=f"{wall:.3f}",
          launches=scrub_launches,
          device_share=f"{t['kernel_ms'] / 1e3 / wall:.5f}",
          kernel_ms=f"{t['kernel_ms']:.1f}")
    check(report.checked == len(metas) and not report.mismatched,
          f"scrub {report}")
    fe.close()

    # 7.3 a same-block degraded-read storm, cached and uncached: one hot
    # data block lost in one stripe per shard, 10 waves of 6 reads each
    hot = next(b for b in code.groups[1] if code.block_type[b] == "d")
    lost = [(sid, hot) for sid in range(SHARDS)]
    saved = {key: store.get(*key) for key in lost}
    for key in lost:
        store.drop_block(*key)
    results = {}
    for cached in (True, False):
        fe = ShardedFrontend(
            codec, num_shards=SHARDS,
            cache=HotBlockCache(capacity_blocks=8) if cached else None,
            analyze_flushes=True)
        out = []
        t0 = time.perf_counter()
        for _ in range(10):
            hs = [fe.submit_degraded_read(metas[s], b)
                  for s, b in lost for _ in range(6)]
            fe.flush()
            out += [h.result() for h in hs]
        wall = time.perf_counter() - t0
        cls = fe.stats[Priority.DEGRADED_READ]
        results[cached] = out
        phase("frontend storm", cached=cached, requests=len(out),
              wall_s=f"{wall:.3f}", requests_s=f"{len(out) / wall:.1f}",
              launches=cls.launches, cache_hits=cls.cache_hits)
        want = len(lost) if cached else 10 * len(lost)
        check(cls.launches == want,
              f"storm cached={cached}: {cls.launches} launches != {want}")
        fe.close()
    check(results[True] == results[False], "cached != uncached")
    for i, data in enumerate(results[True]):
        sid, b = lost[(i // 6) % len(lost)]
        check(data == saved[(sid, b)], f"storm read {sid}/{b}")
    codec.rebuild_blocks(lost)
    for key in lost:
        check(store.get(*key) == saved[key], f"storm rebuild {key}")

    # 7.4 one whole cluster lost: degraded reads decode the 21-erasure
    # pattern (gf_bitmatmul)
    cluster = [store.topo.node_of(0, s) for s in range(
        store.topo.nodes_per_cluster)]
    for nd in cluster:
        store.fail_node(nd)
    targets = [b for b in code.groups[0] if code.block_type[b] == "d"][:3]
    fe = ShardedFrontend(codec, num_shards=SHARDS, analyze_flushes=True)
    backend.reset_times()
    t0 = time.perf_counter()
    hs = [(fe.submit_degraded_read(m, b, reader_cluster=1), m.stripe_id, b)
          for m in metas for b in targets]
    fe.drain()
    wall = time.perf_counter() - t0
    t = backend.take_times()
    for h, sid, b in hs:
        check_read(sid, b, h.result())
    cls = fe.stats[Priority.DEGRADED_READ]
    phase("frontend cluster loss", requests=len(hs), wall_s=f"{wall:.3f}",
          requests_s=f"{len(hs) / wall:.1f}", launches=cls.launches,
          cross_GiB=f"{cls.cross_bytes / GIB:.3f}",
          device_share=f"{t['kernel_ms'] / 1e3 / wall:.5f}",
          kernel_ms=f"{t['kernel_ms']:.1f}")
    check(cls.launches == SHARDS, f"cluster loss: {cls.launches} launches")
    fe.close()
    for nd in cluster:
        store.heal_node(nd)

    launches = {"gf_bitmatmul": gfk.launches, "xor_reduce": xrk.launches}
    plain = {"gf_bitmatmul": gfk.plain_calls, "xor_reduce": xrk.plain_calls}
    phase("frontend path", kernel_launches=json.dumps(launches),
          plain_calls=json.dumps(plain))
    check(all(v > 0 for v in launches.values()),
          "a kernel never launched on the front-end path")
    check(not any(plain.values()), "a plain version ran on the front-end")
    return launches


# the served models: physical parameters (every leaf), checkpoint stripes of
# 180-of-210 at 1 MiB blocks, stripes per encode window (None: the
# manager's default of 64), the traffic: requests of prompt + gen tokens,
# `batch` at a time, and the prefill attention's route: every attention
# layer of each prefill batch launches the flash kernel ("kernel"),
# attends blockwise ("blockwise") or has none ("none"); `counts` cuts the
# depth (the layers of each segment), `reduced` says why a cell is cut
SERVE_CELLS = {
    "llama3.2-3b": dict(params=3_388_910_592, stripes=36, window=None,
                        batch=4, requests=8, prompt=2048, gen=32,
                        attention="kernel"),
    # 21,098,541,568 bytes (the 26 rg blocks' `lam` leaves are fp32) in
    # 112 stripes. Windows of 8 stripes: PyTorch's pinned host cache
    # rounds each of the encode double buffer's four buffers up to a power
    # of two and never splits one, so 8-stripe windows reuse the four
    # 2 GiB buffers phase 4 left cached, where 16 would pin 4 x 4 GiB more
    # beside the 24.6 GB store and the 21 GB restore buffer. 3,968 =
    # 31 x 128 prompt tokens (tile-aligned, as the reference's Pallas
    # route wants) past the 2,048-token window, and decode past it too.
    "recurrentgemma-9b": dict(params=10_549_127_680, stripes=112, window=8,
                              batch=2, requests=4, prompt=3968, gen=32,
                              attention="kernel"),
    # phase 13: minicpm3-4b, the server's default arch, nothing cut: 62
    # MLA layers, 40 heads padded to 48, 8,791,979,008 bytes in 47
    # stripes, windows of 8 as phase 9's; MLA's prefill attends in the
    # per-head form (q, k 64 + 32, v 64, each zero-padded to 128: the
    # flash kernel), its decode on the absorbed latent cache. The llama
    # cell's traffic
    "minicpm3-4b": dict(params=4_395_989_504, stripes=47, window=8,
                        batch=4, requests=8, prompt=2048, gen=32,
                        attention="kernel"),
    # phase 14: phi3.5-moe at full width (d_model 4096, 32 q / 8 kv heads
    # at head dim 128: the bf16 flash kernel; 16 experts of d_ff 6400,
    # top 2, fp32 router), 10,928,332,800 bytes in 58 stripes; the llama
    # cell's traffic
    "phi3.5-moe-42b-a6.6b": dict(
        params=5_463_904_256, stripes=58, window=8, batch=4, requests=8,
        prompt=2048, gen=32, attention="kernel", counts=(4,),
        reduced="depth 4 of 32 layers: the 32-layer model is 83.7 GB of "
                "weights, more than the card's 80 GB"),
    # phase 14b: Kimi K2 Instruct as one EP32 rank at full width (d_model
    # 7168, 64 MLA heads, qk 192 / v 128 padded to 256: the flash kernel
    # at head dim 256; 12 of 384 experts of d_ff 2048 held, top 8 by
    # sigmoid score plus bias, dropless; a shared expert), 10,130,968,576
    # bytes (fp32 routers and biases) in 54 stripes; the llama cell's
    # traffic
    "kimi-k2-instruct-ep32": dict(
        params=5_054_472_704, stripes=54, window=8, batch=4, requests=8,
        prompt=2048, gen=32, attention="kernel", counts=(4,),
        reduced="depth 4 of 60 layers: the 60-layer rank is 81.5 GB of "
                "weights, more than the card's 80 GB"),
    # phase 15: rwkv6-7b, nothing cut: 32 `rwkv` layers of 64 wkv heads of
    # 64 (d 4096, d_ff 14336, vocab 65536), 15,035,801,600 bytes (fp32
    # `decay_base` and `bonus`) in 80 stripes; no attention: the chunked
    # WKV scan, 64 chunks a layer at 2,048 tokens (23-token chunks at the
    # decode check's 2,047). The llama cell's traffic
    "rwkv6-7b": dict(params=7_517_638_656, stripes=80, window=8, batch=4,
                     requests=8, prompt=2048, gen=32, attention="none"),
    # phase 16: llama-3.2-vision-11b at full width: 8 x (4 attn + 1
    # cross_attn), 32 / 8 heads at head dim 128, 19,550,314,560 bytes (the
    # fp32 gates) in 104 stripes; each batch a (4, 6404, 4096) bf16 stub
    # vision input. The flash kernel at every attention: causal
    # self-attention at prefill, and cross-attention, not causal, over
    # 6,404 keys at prefill (Sq 2,048) and at every decode step (Sq 1).
    # The llama cell's traffic
    "llama-3.2-vision-11b": dict(
        params=9_775_157_264, stripes=104, window=8, batch=4, requests=8,
        prompt=2048, gen=32, attention="kernel"),
    # phase 17: hubert-xlarge, nothing cut: 48 `attn` layers, d 1280, 16
    # heads at head dim 80 (blockwise, as the reference routes 80 to jnp),
    # not causal, no embedding: 2,518,120,960 bytes in 14 stripes; the
    # reference's `encode` cell: 8 sequences of 2,048 seeded frame
    # embeddings encoded 4 at a time, no decode
    "hubert-xlarge": dict(params=1_259_060_480, stripes=14, window=8,
                          batch=4, requests=8, prompt=2048,
                          attention="blockwise"),
}


@contextlib.contextmanager
def routing_probe():
    """Records every `models.layers.moe_ffn` call made in the context:
    the router's fp32 logits z (B, S, E), computed as `moe_ffn` computes
    them, the top-K expert sets it picks, sorted (B, S, K), the bf16
    input x and the router. Yields the records' list, in call order."""
    import torch

    from repro_torch.models import layers
    inner, calls = layers.moe_ffn, []

    def probe(params, x, cfg, mesh=None, **kw):
        z = x.float() @ params.router.float()
        _, idx = layers.top_k(torch.softmax(z, dim=-1),
                              cfg.moe.num_experts_per_tok)
        calls.append(dict(z=z, sets=idx.sort(dim=-1).values, x=x,
                          router=params.router))
        return inner(params, x, cfg, mesh, **kw)

    layers.moe_ffn = probe
    try:
        yield calls
    finally:
        layers.moe_ffn = inner


def routing_switches(calls: list, L: int, P: int, B: int) -> list:
    """The tokens whose experts differ between the two paths of the
    decode check, from `routing_probe`'s records of its three forwards
    (the prefill of P tokens, path A; the prefill of P - 1 and the decode
    step, path B; L MoE layers each). Only root switches are listed: a
    switch at (layer l, token t) with none at a lower layer and a token
    <= t, so not a consequence of another. For each: the sequence, layer
    and token, the gap z_o - z_n of path A's router logits between the
    dropped expert o it ranked lowest and the added expert n it ranked
    highest, and the most that moving each element of the bf16 router
    input x by one ulp (2^-8 of |x_k|) can move that gap,
    2^-8 x sum_k |x_k| |w_ko - w_kn|. `near_tie` is gap <= that bound:
    a switch the inputs' rounding explains."""
    import torch

    check(len(calls) == 3 * L, f"{len(calls)} moe_ffn calls, want {3 * L}")
    check(all(c["z"].shape[:2] == (B, P) for c in calls[:L]) and
          all(c["z"].shape[:2] == (B, P - 1) for c in calls[L:2 * L]) and
          all(c["z"].shape[:2] == (B, 1) for c in calls[2 * L:]),
          "moe_ffn calls out of the expected order")
    first = torch.full((B,), P, device=calls[0]["z"].device)
    tpos = torch.arange(P, device=first.device)
    out = []
    for layer in range(L):
        a = calls[layer]
        sa = a["sets"]
        sb = torch.cat([calls[L + layer]["sets"],
                        calls[2 * L + layer]["sets"]], dim=1)
        sw = (sa != sb).any(-1)                                    # (B, P)
        roots = sw & (tpos[None] < first[:, None])
        for b, t in roots.nonzero().tolist():
            z = a["z"][b, t]
            lost = set(sa[b, t].tolist()) - set(sb[b, t].tolist())
            new = set(sb[b, t].tolist()) - set(sa[b, t].tolist())
            o = min(lost, key=lambda e: z[e].item())
            n = max(new, key=lambda e: z[e].item())
            w = a["router"].float()
            bound = (a["x"][b, t].float().abs()
                     * (w[:, o] - w[:, n]).abs()).sum().item() * 2.0 ** -8
            gap = (z[o] - z[n]).item()
            out.append(dict(seq=b, layer=layer, token=t, gap=round(gap, 6),
                            bound=round(bound, 6), near_tie=gap <= bound))
        first = torch.minimum(first, torch.where(sw, tpos[None], P).amin(1))
    return out


def attention_routes(cfg) -> tuple[int, int]:
    """(attention calls per prefill, per decode step) of `cfg`: one per
    self-attention layer (`attn`, `local_attn`, `mla`, `attn_moe`) and per
    `cross_attn` layer at prefill, one per `cross_attn` layer per decode
    step (self-attention decode attends with plain tensor ops); `rg` and
    `rwkv` layers attend to nothing."""
    count = {}
    for seg in cfg.segments:
        for kind in seg.blocks:
            count[kind] = count.get(kind, 0) + seg.count
    cross = count.get("cross_attn", 0)
    return (sum(n for kind, n in count.items()
                if kind not in ("rg", "rwkv")), cross)


def checkpoint_drill(tree, cell: dict, tag: str):
    """6.1-6.3 of the serve path: a parameter tree (on the card) saved as
    UniLRC 180-of-210 stripes (1 MiB blocks, `cell["window"]` stripes an
    encode launch), one node lost, a degraded restore (cluster-local,
    every leaf byte-identical), the rebuild. Returns the restored tree
    (host tensors) and the coding kernels' launches of the save, the
    restore and the rebuild."""
    import torch

    from repro_torch.ckpt import BlockStore, CheckpointManager
    from repro_torch.core import make_unilrc
    from repro_torch.io import TorchBackend
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk
    from repro_torch.topo import Topology

    dev = torch.device("cuda")
    # 6.1 save: the weights as a 180-of-210 checkpoint, 1 MiB blocks
    store = BlockStore(Topology(num_clusters=10, nodes_per_cluster=24))
    mgr = CheckpointManager(store, make_unilrc(2, 10), block_size=MIB,
                            backend=TorchBackend("cuda"))
    if cell["window"]:
        mgr.codec.max_batch_stripes = cell["window"]
    gfk.reset_counts()
    xrk.reset_counts()
    t0 = time.perf_counter()
    nstripes = mgr.save(tree, step=0)
    save_s = time.perf_counter() - t0
    ckpt_bytes = sum(p.numel() * p.element_size() for p in leaves(tree))
    phase(f"{tag}ckpt save", stripes=nstripes, bytes=ckpt_bytes,
          seconds=f"{save_s:.3f}", GiB_s=f"{ckpt_bytes / GIB / save_s:.3f}",
          window_stripes=mgr.codec.max_batch_stripes,
          gf_launches=gfk.launches, xor_launches=xrk.launches)
    check(nstripes == cell["stripes"], f"{nstripes} stripes")
    check(gfk.launches == math.ceil(nstripes / mgr.codec.max_batch_stripes),
          f"{gfk.launches} encode launches for {nstripes} stripes")
    coding = {"gf_bitmatmul": gfk.launches, "xor_reduce": xrk.launches}
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
    phase(f"{tag}ckpt restore", degraded_blocks=report.degraded_blocks,
          total_blocks=report.total_blocks_read,
          cross_cluster_bytes=report.cross_cluster_bytes,
          inner_cluster_bytes=report.inner_cluster_bytes,
          seconds=f"{restore_s:.3f}",
          GiB_s=f"{ckpt_bytes / GIB / restore_s:.3f}",
          gf_launches=gfk.launches, xor_launches=xrk.launches)
    check(report.degraded_blocks > 0, "restore was not degraded")
    check(report.cross_cluster_bytes == 0, "restore crossed clusters")
    coding["gf_bitmatmul"] += gfk.launches
    coding["xor_reduce"] += xrk.launches

    # 6.3 every restored tensor is the saved tensor, byte for byte
    nleaves = 0
    dtypes = set()
    for saved, back in zip(leaves(tree), leaves(restored), strict=True):
        check(saved.shape == back.shape and saved.dtype == back.dtype,
              f"restored leaf {nleaves}: {back.shape} {back.dtype}")
        check(torch.equal(saved.flatten().view(torch.uint8),
                          back.to(dev).flatten().view(torch.uint8)),
              f"restored leaf {nleaves} differs")
        dtypes.add(str(saved.dtype).replace("torch.", ""))
        nleaves += 1
    phase(f"{tag}ckpt bytes", leaves=nleaves, dtypes=",".join(sorted(dtypes)),
          identical=True)
    gfk.reset_counts()
    xrk.reset_counts()
    rebuilt = mgr.reconstruct_failures()
    check(not store.failed_nodes and rebuilt > 0, f"rebuilt {rebuilt}")
    coding["gf_bitmatmul"] += gfk.launches
    coding["xor_reduce"] += xrk.launches
    phase(f"{tag}ckpt rebuild", blocks=rebuilt, gf_launches=gfk.launches,
          xor_launches=xrk.launches, coding_launches=json.dumps(coding))
    return restored, coding


def serve_path(seed: int, arch: str, tag: str = "") -> dict:
    """The serving path of one full-width model (`SERVE_CELLS[arch]`,
    random weights from `seed`, cut in depth where the cell says):
    checkpointed as UniLRC 180-of-210 stripes, restored degraded after a
    node loss, rebuilt and served. Checks every restored byte, the
    restore's locality, the attention route (`attention_routes`: per
    attention layer of each prefill batch and per cross-attention layer
    of each decode step, one flash launch or one blockwise call) and the
    logits; exits on the first failed check. A vision model's gates are
    drawn from U(0.3, 0.9) before the save (at 0 its cross-attention adds
    nothing, and the decode check could not see it) and each batch gets
    stub vision embeddings; an encoder-only model is encoded instead of
    served (`encode_path`). Phase lines are named with `tag` in front.
    Returns the flash kernel's launches, plain calls and blockwise calls
    on the serve or encode run, and the coding kernels' launches of the
    save, the restore and the rebuild (`gf_bitmatmul`, `xor_reduce`)."""
    import copy
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.launch.serve import serve
    from repro_torch.models import (Segment, forward, init_params, layers,
                                    pad_cache_to, params_from_jax,
                                    params_to_tree)
    from repro_torch.models.config import RoutedMoEConfig

    cell = SERVE_CELLS[arch]
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if "counts" in cell:
        cfg = dataclasses.replace(cfg, segments=tuple(
            Segment(seg.blocks, n)
            for seg, n in zip(cfg.segments, cell["counts"], strict=True)))
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-{cfg.num_layers}l")
    if "reduced" in cell:
        phase(f"{tag}serve reduced", arch=arch, reduced=repr(cell["reduced"]))
    attn_layers, cross_layers = attention_routes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, dev)
    gates = []
    for block in model.blocks:
        if block.kind == "cross_attn":
            for g in (block.xattn.gate_attn, block.xattn.gate_ffn):
                g.uniform_(0.3, 0.9, generator=gen)
                gates.append(round(g.item(), 4))
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    phase(f"{tag}serve init", arch=cfg.name, layers=cfg.num_layers,
          attention_layers=attn_layers, cross_attention_layers=cross_layers,
          d_model=cfg.d_model,
          q_heads=cfg.num_heads_padded, kv_heads=cfg.num_kv_heads_padded,
          head_dim=cfg.resolved_head_dim, window=cfg.window, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, params=nparams,
          param_count=cfg.param_count(),
          GB=f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f}",
          gates=json.dumps(gates), seconds=f"{time.perf_counter() - t0:.2f}")
    check(nparams == cell["params"], f"{nparams} parameters")
    tree = params_to_tree(model)
    del model
    restored, coding = checkpoint_drill(tree, cell, tag)
    del tree
    model = params_from_jax(cfg, restored, dev)
    del restored
    gc.collect()
    if not cfg.has_decode:
        return {**encode_path(cfg, model, cell, seed, tag), **coding}

    # 6.4 serve: requests of prompt + gen tokens, `batch` at a time
    B, P, G, REQ = cell["batch"], cell["prompt"], cell["gen"], cell["requests"]
    fak.reset_counts()
    layers.reset_blockwise_calls()
    layers.reset_mla_per_head_calls()
    torch.cuda.synchronize()
    out = serve(cfg, model, batch=B, requests=REQ, prompt_len=P, gen=G,
                seed=seed, device=dev)
    flash = {"launches": fak.launches, "fp32_launches": fak.fp32_launches,
             "decode_launches": fak.decode_launches,
             "plain_calls": fak.plain_calls,
             "blockwise_calls": layers.blockwise_calls,
             "mla_per_head_calls": layers.mla_per_head_calls}
    # the kernel's launches by mode: causal prefill (self-attention), not
    # causal at Sq > 1 (cross-attention prefill) and at Sq == 1
    # (cross-attention decode steps)
    modes = {"self_prefill": fak.mode_launches.get((True, False), 0),
             "cross_prefill": fak.mode_launches.get((False, False), 0),
             "cross_decode": fak.mode_launches.get((False, True), 0)}
    nbatches = math.ceil(REQ / B)
    phase(f"{tag}serve", requests=REQ, batch=B, prompt=P, gen=G,
          seconds=f"{out['seconds']:.3f}",
          tokens_s=f"{out['served_tokens'] / out['seconds']:.1f}",
          generated_tokens_s=f"{REQ * G / out['seconds']:.1f}",
          prefill_ms=",".join(f"{t * 1e3:.2f}" for t in out["prefill_s"]),
          decode_ms_per_token=",".join(f"{t * 1e3 / (G - 1):.3f}"
                                       for t in out["decode_s"]),
          flash=json.dumps(flash), flash_modes=json.dumps(modes))
    want_modes = {"self_prefill": nbatches * (attn_layers - cross_layers),
                  "cross_prefill": nbatches * cross_layers,
                  "cross_decode": nbatches * (G - 1) * cross_layers}
    want = sum(want_modes.values())
    routed = {"kernel": (want, 0), "blockwise": (0, want),
              "none": (0, 0)}[cell["attention"]]
    check(cell["attention"] != "none" or want == 0, "attention in a cell "
          "that has none")
    check((flash["launches"], flash["blockwise_calls"]) == routed,
          f"(flash launches, blockwise calls) "
          f"{(flash['launches'], flash['blockwise_calls'])} != {routed}: "
          f"{nbatches} batches x ({attn_layers} attention layers + "
          f"{G - 1} decode steps x {cross_layers} cross-attention layers),"
          f" {cell['attention']}")
    if cell["attention"] == "kernel":
        check(modes == want_modes, f"flash launches by mode {modes} != "
              f"{want_modes}")
        # every cross-attention decode call (G x 1 <= 16 rows) takes the
        # split-KV decode kernel, and no prefill does
        check(flash["decode_launches"] == modes["cross_decode"],
              f"{flash['decode_launches']} decode-kernel launches != "
              f"{modes['cross_decode']} cross-attention decode calls")
    # MLA layers attend in the per-head form at prefill, once a layer a
    # batch, and on the absorbed latent cache in decode (not counted)
    mla_layers = sum(seg.count for seg in cfg.segments
                     for kind in seg.blocks if kind in ("mla", "mla_moe"))
    check(flash["mla_per_head_calls"] == nbatches * mla_layers,
          f"{flash['mla_per_head_calls']} MLA per-head calls != {nbatches} "
          f"batches x {mla_layers} MLA layers")
    check(flash["fp32_launches"] == 0, "fp32 flash kernel on the serve path")
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
    vision = None
    if cfg.family == "vlm":
        vision = torch.randn((B, cfg.vision_seq, cfg.d_model), generator=rng,
                             device=dev).bfloat16()
    NSTEP = 4

    def decode_vs_prefill(m):
        """-> (max |decode - prefill| / max |logit|, max |logit|, finite,
        decode logits, cache, the same share per sequence)."""
        full, _, _ = forward(m, prompts, mode="prefill", vision=vision)
        want = full[:, -1].float()
        del full
        _, cache, _ = forward(m, prompts[:, :P - 1], mode="prefill",
                              vision=vision)
        cache = pad_cache_to(cache, cfg, P + 2 * NSTEP)
        step, _, _ = forward(m, prompts[:, P - 1:], mode="decode",
                             cache=cache, pos=P - 1)
        got = step[:, 0].float()
        finite = bool(torch.isfinite(want).all() and
                      torch.isfinite(got).all())
        scale = want.abs().max().item()
        per_seq = ((got - want).abs().amax(-1)
                   / want.abs().amax(-1)).tolist()
        return ((got - want).abs().max().item() / scale, scale, finite,
                step, cache, per_seq)

    moe = {}
    if cfg.moe is None:
        rel, scale, finite, step, cache, _ = decode_vs_prefill(model)
    elif isinstance(cfg.moe, RoutedMoEConfig):
        # The dropless route computes every choice on both paths, so only
        # routing's discontinuity can part them: in bf16 the two paths'
        # roundings may switch a near tie of score plus bias. Checked in
        # fp32, as the tests compare MoE models; the served difference
        # and each sequence's are printed
        rel_served, _, _, step, cache, per_seq = decode_vs_prefill(model)
        exact = copy.deepcopy(model).float()
        rel, scale, finite, _, _, _ = decode_vs_prefill(exact)
        del exact
        gc.collect()
        torch.cuda.empty_cache()
        moe = dict(checked="fp32, dropless",
                   bf16_served=f"{rel_served:.5f}",
                   bf16_per_seq=json.dumps([round(r, 5) for r in per_seq]))
    else:
        # Decode equals prefill only where both route every token alike.
        # (a) A prefill of P tokens drops the tokens over an expert's
        # capacity (C slots a row) and a decode step drops none, so where
        # the last token or an earlier one is dropped the two differ by
        # design, in the reference too; the check runs the same weights
        # with the capacity at the row (C = P), as the reference's kimi-k2
        # SMOKE config sets its capacity factor for its decode-vs-train
        # check. (b) Routing is discontinuous: in bf16 the two paths'
        # roundings switch the expert of a token whose router
        # probabilities nearly tie (on the H100: the last token of one
        # of the 4 sequences, 2nd and 3rd probability 0.15498 and 0.15192
        # in the prefill, reversed in the decode step). So the check runs
        # twice: in fp32, as the tests compare MoE models, and on the
        # served bf16 weights, each sequence on its own, where a sequence
        # is exempt only if a token's experts switched between the two
        # paths at a gap the rounding of the router's bf16 input can
        # close (`routing_switches`). The served model's difference, with
        # its drops, is printed.
        dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts
            / cfg.moe.num_experts_per_tok))
        check(layers.moe_capacity(dropless.moe, P) == P, "not dropless")
        rel_served, _, _, step, cache, _ = decode_vs_prefill(model)
        model.cfg = dropless
        try:
            with routing_probe() as calls:
                _, _, bf16_finite, _, _, per_seq = decode_vs_prefill(model)
        finally:
            model.cfg = cfg
        switches = routing_switches(calls, cfg.num_layers, P, B)
        del calls
        exempt = sorted({sw["seq"] for sw in switches if sw["near_tie"]}
                        - {sw["seq"] for sw in switches
                           if not sw["near_tie"]})
        held = [b for b in range(B) if b not in exempt]
        phase(f"{tag}serve bf16 check", capacity=P,
              decode_vs_prefill=json.dumps([round(r, 5) for r in per_seq]),
              bound=0.05, held=json.dumps(held), exempt=json.dumps(exempt),
              switches=json.dumps(switches))
        check(bf16_finite, "non-finite bf16 logits")
        check(2 * len(held) >= B, f"{len(exempt)} of {B} sequences exempt")
        for b in held:
            check(per_seq[b] < 0.05, f"bf16 decode vs prefill, sequence "
                  f"{b}: {per_seq[b]:.4f} of its max |logit|")
        exact = copy.deepcopy(model).float()
        exact.cfg = dropless
        rel, scale, finite, _, _, _ = decode_vs_prefill(exact)
        del exact
        gc.collect()
        torch.cuda.empty_cache()
        moe = dict(checked="fp32, capacity at the row",
                   capacity_served=layers.moe_capacity(cfg.moe, P),
                   capacity_checked=P,
                   bf16_served=f"{rel_served:.5f}")
    phase(f"{tag}serve check", max_abs_logit=f"{scale:.4f}",
          decode_vs_prefill=f"{rel:.5f}", bound=0.05, finite=finite, **moe)
    check(finite, "non-finite logits")
    check(rel < 0.05, f"decode vs prefill {rel:.4f} of max |logit|")

    # 6.6 where a decode step's time goes: host clock over NSTEP steps,
    # then the device time of NSTEP more from torch.profiler, under the
    # port's spans as profiler ranges (each range's device ms a step: the
    # kernels launched under it)
    tok = step[:, 0].argmax(dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(NSTEP):
        forward(model, tok, mode="decode", cache=cache, pos=P + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / NSTEP
    try:
        ranges: dict[str, float] = {}
        with obs.recording(ranges=True):
            ops = device_ops(lambda i: forward(
                model, tok, mode="decode", cache=cache, pos=P + NSTEP + i),
                NSTEP, ranges)
        device_ms = sum(ms for _, ms, _ in ops)
        top = sorted(ops, key=lambda o: -o[1])[:4]
        phase(f"{tag}decode split", step_ms=f"{step_ms:.3f}",
              device_ms=f"{device_ms:.3f}",
              device_share=f"{device_ms / step_ms:.4f}",
              device_ops_per_step=sum(c for _, _, c in ops) // NSTEP,
              top=json.dumps([(k[:40], round(ms, 4)) for k, ms, _ in top]),
              span_device_ms=json.dumps({k: round(ms, 4)
                                         for k, ms in ranges.items()}))
    except RuntimeError as err:         # the profiler is untried there
        phase(f"{tag}decode split", step_ms=f"{step_ms:.3f}",
              device_ms="not measured", profiler_error=repr(str(err)[:200]))
    del cache

    # 6.7 the flash kernel's share of a warm prefill, from the port's spans
    prefill_ms, flash_ms, calls = attention_ms(
        lambda: forward(model, prompts, mode="prefill", vision=vision))
    phase(f"{tag}prefill split", prefill_ms=f"{prefill_ms:.3f}",
          attention=cell["attention"],
          flash_ms=f"{flash_ms:.3f}", flash_calls=calls,
          flash_share=f"{flash_ms / max(prefill_ms, 1e-9):.4f}",
          peak_host_rss_GB=f"{peak_rss_gb():.3f}",
          peak_device_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    prefill_host_split(model, prompts, vision, tag)
    return {**flash, **coding, **modes}


def attention_ms(run) -> tuple[float, float, int]:
    """`run()` once to warm up, then again between two CUDA events under
    the port's span recorder: (the run's ms, its `attention` spans' device
    ms, their count)."""
    import torch

    from repro_torch import obs
    run()
    p0 = torch.cuda.Event(enable_timing=True)
    p1 = torch.cuda.Event(enable_timing=True)
    with obs.recording() as rec:
        p0.record()
        run()
        p1.record()
    p1.synchronize()
    attention = [s for s in rec.spans() if s.name == "attention"]
    return (p0.elapsed_time(p1), sum(s.device_ms for s in attention),
            len(attention))


def device_ops(fn, reps: int, ranges: dict | None = None
               ) -> list[tuple[str, float, int]]:
    """`fn(i)` for i < reps under torch.profiler: (name, device ms per
    call, count) of each device-side event (kernels, copies), as the
    profiler's own table totals them (a CPU op's self device time would
    repeat them); the port's span ranges (`repro_torch.*`), which the
    profiler also shows on the device, are left out, as they would count
    their kernels twice. `ranges`, if given, gets each span range's device
    ms per call: the kernels launched under its host range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    if ranges is not None:
        ranges.update((e.key.removeprefix("repro_torch."),
                       e.device_time_total / 1e3 / reps) for e in rows
                      if e.device_type == DeviceType.CPU
                      and e.key.startswith("repro_torch."))
    return [(e.key, e.self_device_time_total / 1e3 / reps, e.count)
            for e in rows if e.device_type != DeviceType.CPU
            and not e.key.startswith("repro_torch.")]


def prefill_host_split(model, prompts, vision, tag: str) -> None:
    """One prefill's host-clock time beside the device time of another
    (torch.profiler) and the device's busy share: where the host launches
    more than the device computes (rwkv's inter-chunk loop, 64 steps a
    layer at 2,048 tokens), the share says so. The two prefills are two
    runs, so a device-bound prefill can read a share a little over 1."""
    import torch

    from repro_torch.models import forward

    def prefill(_=0):
        forward(model, prompts, mode="prefill", vision=vision)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    try:
        ops = device_ops(prefill, 1)
        device_ms, nops = sum(ms for _, ms, _ in ops), sum(c for *_, c in ops)
    except RuntimeError as err:         # the profiler is untried there
        phase(f"{tag}prefill host split", host_ms=f"{host_ms:.3f}",
              device_ms="not measured", profiler_error=repr(str(err)[:200]))
        return
    phase(f"{tag}prefill host split", host_ms=f"{host_ms:.3f}",
          device_ms=f"{device_ms:.3f}",
          device_share=f"{device_ms / host_ms:.4f}", device_ops=nops)


# phase 17's witness: hubert's full width cut to 2 layers, one sequence
# of 512 frames, on the card and on the CPU
ENCODE_WITNESS = dict(layers=2, frames=512)


def encode_path(cfg, model, cell: dict, seed: int, tag: str) -> dict:
    """An encoder-only model's traffic (the reference's `encode` cell: a
    train-mode forward, here under `torch.inference_mode`): `requests`
    sequences of `prompt` seeded frame embeddings (bf16), `batch` at a
    time. Checks the route (one flash launch or blockwise call per
    attention layer per batch), finite logits of the vocabulary's width,
    each sequence of the first batch encoded alone against its row of the
    batch (5e-2 of max |logit|), and a card-vs-CPU witness at the same
    width cut to 2 layers on 1 x 512 frames (5e-2). Returns the flash
    kernel's launches, plain calls and blockwise calls of the encode
    run."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import (Segment, forward, init_params, layers,
                                    params_from_jax, params_to_tree)

    dev = torch.device("cuda")
    B, S, REQ = cell["batch"], cell["prompt"], cell["requests"]
    attn_layers, _ = attention_routes(cfg)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    batches = [torch.randn((min(B, REQ - i), S, cfg.d_model), generator=rng,
                           device=dev).bfloat16() for i in range(0, REQ, B)]
    fak.reset_counts()
    layers.reset_blockwise_calls()
    times, outs = [], []
    for x in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _, _ = forward(model, x, mode="train")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(logits)
    flash = {"launches": fak.launches, "fp32_launches": fak.fp32_launches,
             "decode_launches": fak.decode_launches,
             "plain_calls": fak.plain_calls,
             "blockwise_calls": layers.blockwise_calls}
    phase(f"{tag}encode", requests=REQ, batch=B, frames=S,
          seconds=f"{sum(times):.3f}",
          frames_s=f"{REQ * S / sum(times):.1f}",
          batch_ms=",".join(f"{t * 1e3:.2f}" for t in times),
          flash=json.dumps(flash))
    want = len(batches) * attn_layers
    routed = ((want, 0) if cell["attention"] == "kernel" else (0, want))
    check((flash["launches"], flash["blockwise_calls"]) == routed,
          f"(flash launches, blockwise calls) "
          f"{(flash['launches'], flash['blockwise_calls'])} != {routed}")
    check(flash["plain_calls"] == 0 and flash["fp32_launches"] == 0,
          "flash plain version or fp32 kernel on the encode path")
    for x, out in zip(batches, outs):
        check(tuple(out.shape) == (x.shape[0], S, cfg.vocab_size),
              f"logits {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()), "non-finite logits")
    # each sequence alone is its row of the batch
    first = outs[0].float()
    scale = first.abs().max().item()
    rows = []
    with torch.inference_mode():
        for i in range(batches[0].shape[0]):
            alone, _, _ = forward(model, batches[0][i:i + 1], mode="train")
            rows.append((alone[0].float() - first[i]).abs().max().item()
                        / scale)
    phase(f"{tag}encode rows", alone_vs_batch=json.dumps(
        [round(r, 5) for r in rows]), bound=0.05, max_abs_logit=f"{scale:.4f}")
    check(max(rows) < 0.05, f"a sequence alone vs its batch row: {rows}")

    # the attention share of a warm batch, from the port's spans
    def encode():
        with torch.inference_mode():
            forward(model, batches[0], mode="train")
    batch_ms, attn_ms, calls = attention_ms(encode)
    phase(f"{tag}encode split", batch_ms=f"{batch_ms:.3f}",
          attention=cell["attention"], attention_ms=f"{attn_ms:.3f}",
          attention_calls=calls,
          attention_share=f"{attn_ms / batch_ms:.4f}",
          peak_host_rss_GB=f"{peak_rss_gb():.3f}",
          peak_device_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del outs, batches

    # the card against the CPU at full width, cut to 2 layers
    (seg,) = cfg.segments
    wcfg = dataclasses.replace(
        cfg, name=f"{cfg.name}-{ENCODE_WITNESS['layers']}l",
        segments=(Segment(seg.blocks, ENCODE_WITNESS["layers"]),))
    t0 = time.perf_counter()
    host = init_params(wcfg, torch.Generator().manual_seed(seed), "cpu")
    card = params_from_jax(wcfg, params_to_tree(host), dev)
    x = torch.randn((1, ENCODE_WITNESS["frames"], cfg.d_model),
                    generator=torch.Generator().manual_seed(seed + 1)
                    ).bfloat16()
    with torch.inference_mode():
        want, _, _ = forward(host, x, mode="train")
        got, _, _ = forward(card, x.to(dev), mode="train")
    want = want.float()
    wscale = want.abs().max().item()
    rel = (got.cpu().float() - want).abs().max().item() / wscale
    phase(f"{tag}encode witness", layers=wcfg.num_layers,
          frames=ENCODE_WITNESS["frames"], card_vs_cpu=f"{rel:.5f}",
          bound=0.05, seconds=f"{time.perf_counter() - t0:.2f}")
    check(rel < 0.05, f"encode card vs CPU {rel:.4f} of max |logit|")
    return flash




# phase 10's settings, from benchmarks/fig_sim_reliability.py: the chain
# panel's stressed rates (repairs ~3x the failure rate, so absorption is
# simulable at n = 42) and the campaign panels' milder rates
SIM_CHAIN = dict(N=4, S_TB=1.0, epsilon=0.0017, delta=0.5, T_hours=300.0,
                 B_Gbps=1.0, node_mttf_years=0.5)
SIM_CAMPAIGN = dict(N=4, S_TB=1.0, epsilon=0.05, delta=0.5, T_hours=48.0,
                    B_Gbps=1.0, node_mttf_years=0.5)
# the chain check's bound, stated before any run: the card's random
# stream is not JAX's, so the reference's pinned-seed CI check does not
# carry over; 3.29 standard errors is the two-sided 0.1% normal quantile
SIM_CHAIN_Z = 3.29


def sim_path() -> dict:
    """Phase 10: the failure/repair simulator on the card.

    10a the §5 chain event by event against the Markov answer (UniLRC and
    ALRC 30-of-42, 400 trials, lifetimes drawn on the device); 10b a
    correlated campaign in metadata mode (UniLRC 180-of-210 on 10 x 24
    nodes, link-charged repair, cluster losses every 1,500 h on average,
    4 years); 10c a data-path trial: the same deployment without cluster
    losses, 23 stripes of 1 MiB blocks written and repaired through
    the front-end for 500 h, every repair launching the coding
    kernels; 10d two data blocks of local group 0 dropped in every stripe
    of 10c and healed by a data-path scheduler (one pattern decode, one
    XOR). Checks every byte; exits on the first failed check. Returns the
    launches per kernel made by the simulator's own modules: 10c's write
    and trial, and 10d's scheduler (not the check's reads and the rebuild
    of repairs still queued at the mission's end)."""
    import torch

    from repro_torch.core import codec as plans
    from repro_torch.core import (MTTDLParams, default_placement,
                                  effective_recovery_traffic,
                                  locality_metrics, make_unilrc,
                                  mttdl_years_stripe, paper_schemes,
                                  tolerable_failures)
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import ops
    from repro_torch.kernels import xor_reduce as xrk
    from repro_torch.sim import (DssTrial, FailureModel, RepairScheduler,
                                 SimConfig, Simulator,
                                 exponential_from_mttf_years, run_campaign,
                                 sample_lifetimes, simulate_stripe_mttdl)
    from repro_torch.topo import Topology

    device = "cuda"
    sync = torch.cuda.synchronize
    kernels = {"gf_bitmatmul": gfk, "xor_reduce": xrk}
    sim_launches = dict.fromkeys(kernels, 0)

    def count_sim() -> dict:
        """Adds the launches since the counts' last reset to the
        simulator's, checks that no plain version ran, and returns them."""
        got = {name: k.launches for name, k in kernels.items()}
        check(not any(k.plain_calls for k in kernels.values()),
              "a plain version ran in the simulator")
        for name, n in got.items():
            sim_launches[name] += n
        return got

    # 10a the chain, event by event ----------------------------------------
    chain = MTTDLParams(**SIM_CHAIN)
    for name in ("UniLRC", "ALRC"):
        code = paper_schemes("30-of-42")[name]
        C = effective_recovery_traffic(
            locality_metrics(code, default_placement(code)), chain.delta)
        f = tolerable_failures(code)
        markov = mttdl_years_stripe(code.n, f, C, chain)
        t0 = time.perf_counter()
        est = simulate_stripe_mttdl(code.n, f, C, chain, trials=400, seed=0,
                                    device=device)
        z = abs(markov - est.mean_years) / (est.std_years
                                            / math.sqrt(est.trials))
        phase("sim chain", code=code.name, trials=est.trials,
              markov_years=f"{markov:.6f}",
              sim_years=f"{est.mean_years:.6f}",
              ci95_years=f"{est.ci95_years:.6f}",
              within_ci=est.contains(markov), z=f"{z:.3f}",
              bound=SIM_CHAIN_Z, seconds=f"{time.perf_counter() - t0:.3f}")
        check(z <= SIM_CHAIN_Z, f"{code.name}: Markov {markov} is {z:.2f} "
              f"standard errors from the simulated {est.mean_years}")

    # 10b correlated campaign, metadata mode -------------------------------
    params = MTTDLParams(**SIM_CAMPAIGN)
    code = make_unilrc(2, 10)
    topo = Topology(10, 24)
    node = exponential_from_mttf_years(params.node_mttf_years)
    cfg = SimConfig(code=code, params=params, topology=topo, n_stripes=2,
                    trials=12, seed=1,
                    mission_hours=4 * 8760.0, device=device,
                    failure_model=FailureModel(
                        node=node, cluster_loss_mean_hours=1500.0))
    t0 = time.perf_counter()
    report = run_campaign(cfg)
    phase("sim campaign", seconds=f"{time.perf_counter() - t0:.3f}",
          mission_hours=cfg.mission_hours, n_stripes=cfg.n_stripes,
          row=json.dumps(report.row()))
    check(report.trials == 12 and report.kernel_launches == 0,
          f"campaign {report}")
    check(report.repaired_blocks > 0 and 0 <= report.degraded_fraction <= 1
          and 0 <= report.cross_traffic_fraction <= 1, f"campaign {report}")

    # 10c data-path trial: real bytes through the coding kernels ------------
    cfg = SimConfig(code=code, params=params, topology=topo, n_stripes=23,
                    trials=1, seed=2505, mission_hours=500.0,
                    data_path=True, block_size=MIB, device=device,
                    failure_model=FailureModel(node=node))
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    init = sample_lifetimes(node, gen, (1, topo.num_nodes), device=device)
    gfk.reset_counts()
    xrk.reset_counts()
    t0 = time.perf_counter()
    trial = DssTrial(cfg, 0, init[0])
    sync()
    codec, store, backend = trial.codec, trial.store, trial.codec.backend
    phase("sim trial write", stripes=len(trial.metas),
          GiB=f"{len(trial.payload) / GIB:.3f}",
          seconds=f"{time.perf_counter() - t0:.3f}",
          gf_launches=count_sim()["gf_bitmatmul"])
    gfk.reset_counts()
    xrk.reset_counts()
    backend.reset_times()
    # host seconds in the decode planner (Gaussian elimination for each
    # new erasure pattern) and in the store's reads and writes, to
    # attribute the trial's host time
    split = {"plan_s": 0.0, "get_s": 0.0, "put_s": 0.0}

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            split[key] += time.perf_counter() - t0
            return out
        return call
    plan_fn = plans.decode_plan
    plans.decode_plan = timed("plan_s", plan_fn)
    store.get_many = timed("get_s", store.get_many)
    store.put = timed("put_s", store.put)
    before = sum(ops.KERNEL_LAUNCHES.values())
    t0 = time.perf_counter()
    try:
        result = trial.run()
        sync()
    finally:
        plans.decode_plan = plan_fn
        del store.get_many, store.put
    wall = time.perf_counter() - t0
    t = backend.take_times()
    led = trial.scheduler.ledger
    counted = sum(ops.KERNEL_LAUNCHES.values()) - before
    run = count_sim()
    device_ms = t["h2d_ms"] + t["kernel_ms"] + t["d2h_ms"]
    phase("sim trial", mission_hours=cfg.mission_hours,
          events=trial.sim.events_handled, lost=result.lost,
          repaired_blocks=led.repaired_blocks, jobs=led.jobs,
          plan_groups=led.plan_groups,
          multi_erasure_blocks=led.multi_erasure_blocks,
          max_concurrent_jobs=led.max_concurrent_jobs,
          cross_traffic_fraction=f"{led.cross_traffic_fraction:.4f}",
          data_GiB_read=f"{led.data_bytes_read / GIB:.3f}",
          gf_launches=run["gf_bitmatmul"], xor_launches=run["xor_reduce"],
          seconds=f"{wall:.3f}", device_share=f"{device_ms / 1e3 / wall:.4f}",
          h2d_ms=f"{t['h2d_ms']:.1f}", kernel_ms=f"{t['kernel_ms']:.1f}",
          d2h_ms=f"{t['d2h_ms']:.1f}", pin_s=f"{t['pin_s']:.3f}",
          stage_s=f"{t['stage_s']:.3f}", land_s=f"{t['land_s']:.3f}",
          **{key: f"{value:.3f}" for key, value in split.items()})
    check(not result.lost, "the data-path trial lost data")
    check(led.repaired_blocks > 0, "the data-path trial repaired nothing")
    total = sum(run.values())
    check(led.kernel_launches == led.plan_groups == counted == total,
          f"launches: ledger {led.kernel_launches}, plan groups "
          f"{led.plan_groups}, counted {counted}, kernels {total}")
    check(run["xor_reduce"] > 0, "no XOR repair launched")
    # the check's own launches (degraded reads, the queued repairs) are
    # counted apart from the simulator's
    gfk.reset_counts()
    xrk.reset_counts()
    t0 = time.perf_counter()
    pending = sorted((sid, b) for sid, miss in trial.missing.items()
                     for b in miss)
    check(codec.read_all(trial.metas) == trial.payload,
          "data-path trial payload differs")
    if pending:                 # repairs still queued at the mission's end
        codec.rebuild_blocks(pending)
    check(all(store.available(sid, b) for sid in range(cfg.n_stripes)
              for b in range(code.n)), "a block is still missing")
    phase("sim trial check", identical=True, pending_rebuilt=len(pending),
          seconds=f"{time.perf_counter() - t0:.3f}",
          gf_launches=gfk.launches, xor_launches=xrk.launches)

    # 10d a shared two-erasure pattern across all 23 stripes, healed by the
    # scheduler: one pattern decode (gf), then one XOR for the rest ---------
    b1, b2 = [b for b in code.groups[0] if code.block_type[b] == "d"][:2]
    pairs = []
    for sid in range(cfg.n_stripes):
        store.drop_block(sid, b1)
        store.drop_block(sid, b2)
        pairs += [(sid, b1), (sid, b2)]
    sim = Simulator()
    healed = []

    def missing(sid):
        return frozenset(b for b in range(code.n)
                         if not store.available(sid, b))

    sched = RepairScheduler(sim, codec.placement, params,
                            block_TB=params.S_TB / code.n,
                            stripe_missing=missing, on_repaired=healed.extend,
                            codec=codec)
    gfk.reset_counts()
    xrk.reset_counts()
    backend.reset_times()
    t0 = time.perf_counter()
    sched.damaged(pairs)
    sim.run()
    sync()
    wall = time.perf_counter() - t0
    t = backend.take_times()
    led = sched.ledger
    run = count_sim()
    phase("sim pattern", pairs=len(pairs), jobs=led.jobs,
          launches=led.kernel_launches, plan_groups=led.plan_groups,
          multi_erasure_blocks=led.multi_erasure_blocks,
          gf_launches=run["gf_bitmatmul"], xor_launches=run["xor_reduce"],
          seconds=f"{wall:.3f}",
          device_share=f"{(t['h2d_ms'] + t['kernel_ms'] + t['d2h_ms']) / 1e3 / wall:.4f}",
          kernel_ms=f"{t['kernel_ms']:.1f}")
    check(sorted(healed) == sorted(pairs), "pattern repair left pairs")
    check((led.kernel_launches, led.plan_groups, led.multi_erasure_blocks)
          == (2, 2, cfg.n_stripes), f"pattern ledger {led}")
    check((run["gf_bitmatmul"], run["xor_reduce"]) == (1, 1),
          "pattern repair: not one gf and one xor launch")
    check(codec.read_all(trial.metas) == trial.payload,
          "payload differs after the pattern repair")
    phase("sim path", kernel_launches=json.dumps(sim_launches))
    check(all(v > 0 for v in sim_launches.values()),
          "a kernel never launched on the simulator path")
    return sim_launches


# phase 3's gradient check: the flash layer's dq, dk, dv (kernel forward,
# blockwise PyTorch backward) against its plain forward's at the train
# shape, and against fp32 autograd through naive attention
GRAD_TOL = 2e-2


def naive_attention(q, k, v, causal: bool, window: int):
    """fp32 softmax attention with GQA, every score materialised."""
    import torch
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    qp = torch.arange(q.shape[2], device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None]
    mask = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    return torch.softmax(s.masked_fill(~mask, -torch.inf), -1) @ v


def flash_grad_check(gen, dev) -> dict:
    """Checks the layer's gradient (exits on a miss) and times the
    backward beside the forward kernel and SDPA's forward + backward.
    Launches made here are checks, not path launches."""
    import torch

    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import layers

    def rel(got, want) -> float:
        return ((got.float() - want.float()).abs().max().item()
                / want.float().abs().max().item())

    def layer_grads(q, k, v, do, window):
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fak.launches
        layers.flash_attention(*leaves_, causal=True,
                               window=window).backward(do)
        torch.cuda.synchronize()
        check(fak.launches == before + 1, "layer gradient: not one launch")
        return [t.grad for t in leaves_]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    # (a) the train shape: the same backward from the plain forward
    B, Hq, Hkv, S, d = 4, 32, 8, 2048, 128
    q, k, v, do = randn(B, Hq, S, d), randn(B, Hkv, S, d), \
        randn(B, Hkv, S, d), randn(B, Hq, S, d)
    got = layer_grads(q, k, v, do, 0)
    p_out, p_lse = fak.flash_attention_fwd_plain(q, k, v, causal=True)
    want = layers.flash_attention_bwd(q, k, v, p_out, p_lse, do, causal=True)
    err_plain = max(rel(g, w) for g, w in zip(got, want))
    del got, want, p_out, p_lse
    out, lse = fak.flash_attention_fwd(q, k, v, causal=True)
    bwd_ms = time_ms(lambda: layers.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True), 5)
    fwd_ms = time_ms(lambda: fak.flash_attention_fwd(q, k, v, causal=True),
                     10)
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))

    def library():          # timed as a yardstick only, never on the path
        torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True, enable_gqa=True).backward(do)
    lib_ms = time_ms(library, 10)
    del q, k, v, do, out, lse, lq, lk, lv
    phase("flash grad vs plain", B=B, Hq=Hq, Hkv=Hkv, S=S, d=d, causal=True,
          max_rel_err=f"{err_plain:.3e}", tol=GRAD_TOL,
          bwd_ms=f"{bwd_ms:.3f}", fwd_kernel_ms=f"{fwd_ms:.4f}",
          bwd_over_fwd=f"{bwd_ms / fwd_ms:.1f}",
          sdpa_fwd_bwd_ms=f"{lib_ms:.4f}")
    check(err_plain <= GRAD_TOL, f"flash gradient vs plain {err_plain}")
    # (b) fp32 autograd through naive attention, causal and windowed
    errs = {}
    for window in (0, 128):
        q, k, v, do = randn(1, 4, 512, 128), randn(1, 2, 512, 128), \
            randn(1, 2, 512, 128), randn(1, 4, 512, 128)
        got = layer_grads(q, k, v, do, window)
        ref = [t.float().requires_grad_() for t in (q, k, v)]
        naive_attention(*ref, True, window).backward(do.float())
        errs[window] = max(rel(g, r.grad) for g, r in zip(got, ref))
    phase("flash grad vs naive fp32", B=1, Hq=4, Hkv=2, S=512, d=128,
          causal=True, windows="0,128",
          max_rel_err=json.dumps({w: f"{e:.3e}" for w, e in errs.items()}),
          tol=GRAD_TOL)
    check(max(errs.values()) <= GRAD_TOL, f"flash gradient vs naive {errs}")
    return dict(backward_ms=bwd_ms, backward_max_rel_err=err_plain,
                library_fwd_bwd_ms=lib_ms)


# phase 11: training at llama3.2-3b's full width, cut to 8 of its 28
# layers: save and restore each hold the serialized buffer beside the
# store's stripes (2.17 x the state on the host), and the 28-layer state
# (47.4 GB) would need 102.8 GB of the 96 GiB host; 8 layers are 17.5 GB
TRAIN = dict(layers=8, batch=8, seq=2048, accum=2, remat="block", lr=1e-3,
             warmup_steps=10, clip_norm=1.0, save_at=3, stripes=93,
             heldout=1000, low_lr=1e-4)
FLASH_PER_STEP = TRAIN["layers"] * TRAIN["accum"] * 2   # + the recompute


def heldout_loss(model, ds) -> float:
    """`loss_fn` without grad on the batch of step TRAIN["heldout"], which
    no run here trains on, in microbatches of TRAIN["accum"]."""
    import torch

    from repro_torch.train import loss_fn
    tokens, labels = (torch.as_tensor(t, device=model.embed.device)
                      for t in ds.batch(TRAIN["heldout"]))
    mb = tokens.shape[0] // TRAIN["accum"]
    with torch.no_grad():
        return statistics.fmean(
            float(loss_fn(model, tokens[i:i + mb], labels[i:i + mb])[0])
            for i in range(0, tokens.shape[0], mb))


def vmrss_gb() -> float:
    """This process's resident host memory now (VmRSS), in GB."""
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


def peak_rss_gb() -> float:
    """This process's peak resident host memory so far, in GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def train_path(seed: int) -> dict:
    """Phase 11: `init_train_state`, `make_train_step` and the UniLRC
    checkpoint drill the training CLI runs, at full width: steps 0-2, a
    save at step 3, step 3, a node lost, a degraded restore, the rebuild,
    step 3 again from the restored state, and step 4. Checks the losses,
    the flash launches per step, the launches of the save and the restore,
    every restored byte and the replayed loss; exits on a miss. Returns
    the path's launches per kernel."""
    import dataclasses

    import torch

    from repro_torch.ckpt import BlockStore, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import make_unilrc
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.io import TorchBackend
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk
    from repro_torch.models import layers, uniform_segments
    from repro_torch.optim import AdamWConfig
    from repro_torch.topo import Topology
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_from_jax,
                                   train_state_to_tree)
    from repro_torch.train import step as step_mod

    dev = torch.device("cuda")
    full = get_config("llama3.2-3b")
    cfg = dataclasses.replace(full, name=f"llama3.2-3b-{TRAIN['layers']}l",
                              segments=uniform_segments("attn",
                                                        TRAIN["layers"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, gen, dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in state.params)
    state_bytes = sum(p.numel() * (p.element_size() + 12)
                      for p in state.params)
    phase("train init", arch=cfg.name, layers=cfg.num_layers,
          of_layers=full.num_layers, d_model=cfg.d_model,
          q_heads=cfg.num_heads_padded, kv_heads=cfg.num_kv_heads_padded,
          d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=nparams,
          param_count=cfg.param_count(), state_GB=f"{state_bytes / 1e9:.3f}",
          seconds=f"{time.perf_counter() - t0:.2f}")
    B, S = TRAIN["batch"], TRAIN["seq"]
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, S, B, seed=0))
    ocfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup_steps"],
                       total_steps=TRAIN["save_at"] + 2,
                       clip_norm=TRAIN["clip_norm"])
    step_fn = make_train_step(cfg, ocfg, TrainConfig(
        accum=TRAIN["accum"], remat=TRAIN["remat"]))
    heldout = {"before": heldout_loss(state.model, ds)}

    # CUDA events around the flash forward kernel, the attention backward
    # and the optimizer, inside each step
    spans: dict[str, list] = {"flash_fwd": [], "attn_bwd": [], "optim": []}

    def timed(name, fn):
        def wrapper(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return wrapper
    originals = (fak.flash_attention_fwd, layers.flash_attention_bwd,
                 step_mod.adamw_update)
    fak.flash_attention_fwd = timed("flash_fwd", originals[0])
    layers.flash_attention_bwd = timed("attn_bwd", originals[1])
    step_mod.adamw_update = timed("optim", originals[2])
    flops = (6 * cfg.param_count() * B * S + 12 * cfg.num_layers * B
             * cfg.num_heads * S * S // 2 * cfg.resolved_head_dim)
    launches = {"flash_attention": 0, "flash_decode": 0, "gf_bitmatmul": 0,
                "xor_reduce": 0}
    steps: list[dict] = []

    def train_step(state, i, tag=""):
        tokens, labels = ds.batch(i)
        for v in spans.values():
            v.clear()
        fak.reset_counts()
        layers.reset_blockwise_calls()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        e0.record()
        state, m = step_fn(state, tokens, labels)
        e1.record()
        e1.synchronize()
        wall = time.perf_counter() - w0
        ms = e0.elapsed_time(e1)
        split = {k: sum(a.elapsed_time(b) for a, b in v)
                 for k, v in spans.items()}
        row = dict(step=i, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                   ms=ms, wall_s=wall, **split,
                   rest=ms - sum(split.values()),
                   flash=fak.launches, plain=fak.plain_calls,
                   blockwise=layers.blockwise_calls)
        phase(f"train step{tag}", step=i, loss=f"{row['loss']:.6f}",
              grad_norm=f"{row['grad_norm']:.4f}", lr=f"{row['lr']:.3e}",
              step_ms=f"{ms:.2f}", tokens_s=f"{B * S / (ms / 1e3):.1f}",
              mfu=f"{flops / (ms / 1e3) / BF16_OPS_PER_S:.4f}",
              flash_fwd_ms=f"{split['flash_fwd']:.2f}",
              attn_bwd_ms=f"{split['attn_bwd']:.2f}",
              optim_ms=f"{split['optim']:.2f}",
              rest_ms=f"{row['rest']:.2f}", flash_launches=fak.launches,
              plain=fak.plain_calls, blockwise=layers.blockwise_calls,
              peak_device_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
              f"step {i}: loss {row['loss']}, grad norm {row['grad_norm']}")
        check(fak.launches == FLASH_PER_STEP and fak.plain_calls == 0
              and layers.blockwise_calls == 0,
              f"step {i}: {fak.launches} flash launches (want "
              f"{FLASH_PER_STEP}), {fak.plain_calls} plain, "
              f"{layers.blockwise_calls} blockwise")
        launches["flash_attention"] += fak.launches - fak.decode_launches
        launches["flash_decode"] += fak.decode_launches
        steps.append(row)
        return state

    try:
        for i in range(TRAIN["save_at"]):
            state = train_step(state, i)

        # the checkpoint at step 3: phase 4's deployment, 1 MiB blocks,
        # windows of 8 stripes
        store = BlockStore(Topology(num_clusters=10, nodes_per_cluster=24))
        mgr = CheckpointManager(store, make_unilrc(2, 10), block_size=MIB,
                                backend=TorchBackend("cuda"))
        mgr.codec.max_batch_stripes = 8
        tree = train_state_to_tree(state)
        rss = {"before_save": vmrss_gb()}
        ckpt_bytes = sum(t.numel() * t.element_size() for t in leaves(tree))
        gfk.reset_counts()
        xrk.reset_counts()
        t0 = time.perf_counter()
        nstripes = mgr.save(tree, step=TRAIN["save_at"])
        save_s = time.perf_counter() - t0
        rss["after_save"] = vmrss_gb()
        phase("train ckpt save", stripes=nstripes, bytes=ckpt_bytes,
              seconds=f"{save_s:.3f}",
              GiB_s=f"{ckpt_bytes / GIB / save_s:.3f}",
              gf_launches=gfk.launches, xor_launches=xrk.launches,
              vmrss_GB=json.dumps({k: f"{v:.3f}" for k, v in rss.items()}))
        check(nstripes == TRAIN["stripes"], f"{nstripes} stripes")
        check(gfk.launches == math.ceil(nstripes / 8) and xrk.launches == 0,
              f"save: {gfk.launches} encode launches for {nstripes} "
              f"stripes, {xrk.launches} xor")
        launches["gf_bitmatmul"] += gfk.launches

        state = train_step(state, TRAIN["save_at"], " first pass")
        first = steps[-1]["loss"]

        # one node lost: degraded restore, cluster-local, byte for byte
        store.fail_node(store.node_of(0, 0))
        gfk.reset_counts()
        xrk.reset_counts()
        t0 = time.perf_counter()
        restored, report = mgr.restore(TRAIN["save_at"])
        restore_s = time.perf_counter() - t0
        rss["after_restore"] = vmrss_gb()
        phase("train ckpt restore", degraded_blocks=report.degraded_blocks,
              total_blocks=report.total_blocks_read,
              cross_cluster_bytes=report.cross_cluster_bytes,
              seconds=f"{restore_s:.3f}",
              GiB_s=f"{ckpt_bytes / GIB / restore_s:.3f}",
              gf_launches=gfk.launches, xor_launches=xrk.launches,
              vmrss_GB=json.dumps({k: f"{v:.3f}" for k, v in rss.items()}))
        check(report.degraded_blocks > 0, "restore was not degraded")
        check(report.cross_cluster_bytes == 0, "restore crossed clusters")
        check(gfk.launches == 0 and xrk.launches > 0,
              f"restore: {gfk.launches} gf, {xrk.launches} xor launches")
        launches["xor_reduce"] += xrk.launches
        nleaves = 0
        for saved, back in zip(leaves(tree), leaves(restored), strict=True):
            check(saved.shape == back.shape and saved.dtype == back.dtype,
                  f"restored leaf {nleaves}: {back.shape} {back.dtype}")
            check(torch.equal(
                saved.flatten().view(torch.uint8),
                back.to(saved.device).flatten().view(torch.uint8)),
                f"restored leaf {nleaves} differs")
            nleaves += 1
        phase("train ckpt bytes", leaves=nleaves, identical=True)
        del tree
        rebuilt = mgr.reconstruct_failures()
        check(not store.failed_nodes and rebuilt > 0, f"rebuilt {rebuilt}")

        # the restored state back on the card: step 3 again, then step 4
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state = train_state_from_jax(cfg, restored, dev)
        del restored, mgr, store
        gc.collect()
        check(int(state.step) == TRAIN["save_at"], f"step {int(state.step)}")
        state = train_step(state, TRAIN["save_at"], " replay")
        replay = steps[-1]["loss"]
        rel = abs(replay - first) / abs(first)
        phase("train replay", first_pass=f"{first:.6f}",
              replay=f"{replay:.6f}", rel=f"{rel:.3e}", bound=1e-3,
              bitwise=replay == first)
        check(rel <= 1e-3, f"replayed step {TRAIN['save_at']}: {rel}")
        state = train_step(state, TRAIN["save_at"] + 1)
    finally:
        (fak.flash_attention_fwd, layers.flash_attention_bwd,
         step_mod.adamw_update) = originals
    heldout["after"] = heldout_loss(state.model, ds)
    steady = steps[1:TRAIN["save_at"]]
    step_ms = statistics.median(r["ms"] for r in steady)
    phase("train path", steps=len(steps), step_ms=f"{step_ms:.2f}",
          tokens_s=f"{B * S / (step_ms / 1e3):.1f}",
          mfu=f"{flops / (step_ms / 1e3) / BF16_OPS_PER_S:.4f}",
          flops_per_step=flops,
          split_ms=json.dumps({k: round(statistics.median(
              r[k] for r in steady), 3) for k in
              ("flash_fwd", "attn_bwd", "optim", "rest")}),
          save_s=f"{save_s:.3f}", restore_s=f"{restore_s:.3f}",
          peak_device_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
          kernel_launches=json.dumps(launches),
          losses=json.dumps([round(r["loss"], 6) for r in steps]),
          heldout_loss=json.dumps({k: round(v, 6)
                                   for k, v in heldout.items()}))
    check(all(map(math.isfinite, heldout.values())), f"held-out {heldout}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_low_lr(seed: int) -> None:
    """Phase 11c: phase 11's model, initial state (the same seed) and
    batches, five steps at a tenth of its learning rate, on the card. The
    held-out loss must fall. Exits on a miss."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.models import uniform_segments
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              segments=uniform_segments("attn",
                                                        TRAIN["layers"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_train_state(cfg, gen, dev)
    B, S = TRAIN["batch"], TRAIN["seq"]
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, S, B, seed=0))
    step_fn = make_train_step(cfg, AdamWConfig(
        lr=TRAIN["low_lr"], warmup_steps=TRAIN["warmup_steps"],
        total_steps=TRAIN["save_at"] + 2, clip_norm=TRAIN["clip_norm"]),
        TrainConfig(accum=TRAIN["accum"], remat=TRAIN["remat"]))
    heldout = {"before": heldout_loss(state.model, ds)}
    losses = []
    for i in range(TRAIN["save_at"] + 2):
        state, m = step_fn(state, *ds.batch(i))
        losses.append(round(float(m["loss"]), 6))
    heldout["after"] = heldout_loss(state.model, ds)
    phase("train low lr", lr=TRAIN["low_lr"], losses=json.dumps(losses),
          heldout_loss=json.dumps({k: round(v, 6)
                                   for k, v in heldout.items()}))
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    check(heldout["after"] < heldout["before"],
          f"at lr {TRAIN['low_lr']} the held-out loss did not fall: "
          f"{heldout}")
    del state
    gc.collect()
    torch.cuda.empty_cache()


# phase 11's witness: phase 11's train step at a model's full width
# (llama3.2-3b: vocab 128,256, 24 -> 32 heads with ghosts; minicpm3-4b,
# phase 11d: MLA, 40 -> 48 heads, vocab 73,448; accum 2, remat, the same
# optimizer settings) on the card and on the CPU, whose arithmetic the CPU
# tests hold to the reference's; cut to 2 layers and 2 x 256 tokens a
# step so that a CPU step takes seconds
WITNESS = dict(layers=2, batch=2, seq=256, steps=3)
# The first step's m, card against CPU, as a share of each leaf's max |m|.
# The bounds are set from `tools/witness_drift.py` on the H100 (seeds
# 2505, 1, 2), which also takes the step in fp32 on the CPU: llama's worst
# leaf reads 0.93-1.23e-2 card vs CPU. MLA's q path (q_norm, w_dq, w_uq,
# w_uk) reads 1.89-2.10e-2, and there both devices miss the fp32 step by
# more than they miss each other (card 2.7-3.2e-2, CPU 2.4-3.0e-2): the
# bf16 rounding both share, not the card, so 2e-2 holds no room for MLA.
WITNESS_M_BOUND = {"llama3.2-3b": 2e-2, "minicpm3-4b": 3e-2}


def train_witness(seed: int, arch: str = "llama3.2-3b",
                  tag: str = "") -> None:
    """Phase 11b (llama3.2-3b) and 11d (minicpm3-4b, `tag` "mla "): the
    same initial state, from `seed` on the CPU, and the same batches on
    the card and on the CPU for WITNESS["steps"] steps of phase 11's
    settings. Checks each step's loss and grad norm within 2e-2 relative,
    the first step's gradient leaf by leaf (the first moment m, (1 - b1) x
    the clipped gradient, within `WITNESS_M_BOUND[arch]` of each leaf's
    max |m|: 2e-2 for llama, 3e-2 for MLA), and the
    attention's route: through the flash kernel on the card (MLA in its
    per-head form, padded to 128), its plain version on the CPU. Exits on
    a miss."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import Segment, layers
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_from_jax,
                                   train_state_to_tree)

    dev = torch.device("cuda")
    full = get_config(arch)
    (seg,) = full.segments
    cfg = dataclasses.replace(full, name=f"{arch}-{WITNESS['layers']}l",
                              segments=(Segment(seg.blocks,
                                                WITNESS["layers"]),))
    t0 = time.perf_counter()
    host = init_train_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    card = train_state_from_jax(cfg, train_state_to_tree(host), dev)
    names = [n for n, _ in host.model.named_parameters()]
    phase(f"{tag}train witness init", arch=cfg.name,
          params=cfg.param_count(), q_heads=cfg.num_heads_padded,
          vocab=cfg.vocab_size, seconds=f"{time.perf_counter() - t0:.2f}")
    B, S = WITNESS["batch"], WITNESS["seq"]
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, S, B, seed=0))
    step = make_train_step(
        cfg, AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup_steps"],
                         total_steps=WITNESS["steps"],
                         clip_norm=TRAIN["clip_norm"]),
        TrainConfig(accum=TRAIN["accum"], remat=TRAIN["remat"]))
    per_step = WITNESS["layers"] * TRAIN["accum"] * 2
    m_bound = WITNESS_M_BOUND[arch]
    want_counts = (per_step, 0, 0)
    losses: dict[str, list[float]] = {"card": [], "cpu": []}
    for i in range(WITNESS["steps"]):
        tokens, labels = ds.batch(i)
        fak.reset_counts()
        layers.reset_blockwise_calls()
        card, got = step(card, tokens, labels)
        torch.cuda.synchronize()
        counts = (fak.launches, fak.plain_calls, layers.blockwise_calls)
        fak.reset_counts()
        t0 = time.perf_counter()
        host, want = step(host, tokens, labels)
        cpu_s = time.perf_counter() - t0
        check(fak.plain_calls == per_step,
              f"witness step {i}: {fak.plain_calls} plain calls on the "
              f"CPU, want {per_step}")
        rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
               for k in ("loss", "grad_norm")}
        losses["card"].append(float(got["loss"]))
        losses["cpu"].append(float(want["loss"]))
        phase(f"{tag}train witness step", step=i,
              loss_card=f"{float(got['loss']):.6f}",
              loss_cpu=f"{float(want['loss']):.6f}",
              grad_norm_card=f"{float(got['grad_norm']):.4f}",
              grad_norm_cpu=f"{float(want['grad_norm']):.4f}",
              rel_loss=f"{rel['loss']:.3e}",
              rel_grad_norm=f"{rel['grad_norm']:.3e}", bound=2e-2,
              cpu_step_s=f"{cpu_s:.2f}", flash_launches=counts[0],
              plain=counts[1], blockwise=counts[2])
        check(counts == want_counts,
              f"witness step {i}: (flash, plain, blockwise) = {counts}, "
              f"want {want_counts}")
        check(math.isfinite(losses["card"][-1]),
              f"witness step {i}: loss {losses['card'][-1]}")
        for k, r in rel.items():
            check(r <= 2e-2, f"witness step {i}: {k} card "
                  f"{float(got[k])} vs cpu {float(want[k])}")
        if i == 0:
            worst = (0.0, "")
            for name, a, b in zip(names, host.opt["m"], card.opt["m"]):
                scale = a.abs().max().item()
                err = (b.cpu() - a).abs().max().item()
                check(err <= m_bound * scale,
                      f"witness step 0: m of {name} off by {err} "
                      f"(max |m| {scale})")
                if scale and err / scale > worst[0]:
                    worst = (err / scale, name)
            phase(f"{tag}train witness grads", leaves=len(names),
                  max_rel_err=f"{worst[0]:.3e}", worst_leaf=worst[1],
                  bound=m_bound)
    phase(f"{tag}train witness", steps=WITNESS["steps"],
          losses=json.dumps({k: [round(x, 6) for x in v]
                             for k, v in losses.items()}))
    del host, card
    gc.collect()
    torch.cuda.empty_cache()


def train_cli_phase() -> None:
    """Phase 12: `repro_torch.launch.train.run` on the card at its SMOKE
    config (head dim 16: blockwise attention, the same backward), the
    verify recipe's drill. Exits on a miss."""
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.launch import train as train_cli
    from repro_torch.models import layers

    fak.reset_counts()
    layers.reset_blockwise_calls()
    t0 = time.perf_counter()
    losses = train_cli.run(["--smoke", "--steps", "30", "--batch", "2",
                            "--seq", "64", "--ckpt-every", "10",
                            "--fail-node", "5", "--fail-at", "20",
                            "--log-every", "10"])
    phase("train cli", seconds=f"{time.perf_counter() - t0:.2f}",
          steps=len(losses), first=f"{losses[0]:.4f}",
          last=f"{losses[-1]:.4f}", flash_launches=fak.launches,
          plain=fak.plain_calls, blockwise=layers.blockwise_calls)
    check(len(losses) == 30 and losses[-1] < losses[0],
          f"training CLI: losses {losses[0]} -> {losses[-1]}")
    check(fak.launches == 0 and fak.plain_calls == 0,
          "flash kernel or plain version at head dim 16")
    check(layers.blockwise_calls == 30 * 2, "blockwise attention calls")


def examples_phase() -> dict:
    """The example programs on the card, as a user runs them:
    `examples/serving_torch.py` at its defaults (minicpm3-4b SMOKE: the
    weight registry restored degraded with a node down, the front-end's
    traffic and scrub, prefill and decode) and
    `examples/train_with_failures_torch.py` at its defaults (300 steps of
    a 100M-parameter llama clone at head dim 64, the flash kernel's d = 64
    instantiation; checkpoints, a node lost, a degraded restore, its own
    assertion that the loss falls by 0.3). Their output is kept and its
    last lines printed. Returns the training run's flash launches. Exits
    on a miss: an example's own assertion raises."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import layers

    counts = {}
    for name, ok in (("serving_torch", "serving OK"),
                     ("train_with_failures_torch",
                      "train-with-failures OK")):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fak.reset_counts()
        layers.reset_blockwise_calls()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = mod.main([])
        seconds = time.perf_counter() - t0
        lines = out.getvalue().strip().splitlines()
        counts[name] = {"launches": fak.launches,
                        "fp32_launches": fak.fp32_launches,
                        "decode_launches": fak.decode_launches,
                        "plain_calls": fak.plain_calls,
                        "blockwise_calls": layers.blockwise_calls}
        phase(f"example {name}", seconds=f"{seconds:.2f}",
              flash=json.dumps(counts[name]), last=json.dumps(lines[-3:]))
        check(lines[-1] == ok, f"{name}: last line {lines[-1]!r}")
        check(counts[name]["plain_calls"] == 0, f"{name}: a plain version")
        if name.startswith("train"):
            # no remat: one forward a step, 12 attention layers at d = 64
            check(counts[name]["launches"] == 12 * len(result) and
                  counts[name]["blockwise_calls"] == 0,
                  f"{name}: {counts[name]} for {len(result)} steps")
    return counts["train_with_failures_torch"]


#: phase 18's dry-run cells: the training cell, expert parallelism over
#: 512 ranks, and a recurrent state at 524288 tokens of context
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", "single"),
                ("kimi-k2-1t-a32b", "decode_32k", "multi"),
                ("rwkv6-7b", "long_500k", "single"),
                ("hubert-xlarge", "prefill_32k", "single"))
#: the port's kernel operators a cell must trace (`op_audit["custom"]`):
#: hubert's head dim 80 takes the blockwise operator once a layer (C4)
DRYRUN_CUSTOM_OPS = {("hubert-xlarge", "prefill_32k", "single"): 48}
#: wall seconds a cell may take
DRYRUN_CELL_S = {("hubert-xlarge", "prefill_32k", "single"): 180}
CARD_BYTES = 80e9


def dryrun_start() -> list:
    """Starts phase 18's dry-run cells, one process each (on the CPU: the
    production meshes are fake; the card stays this process's)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    return [(cell, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)) for cell in DRYRUN_CELLS]


def dryrun_finish(procs: list, timeout: float = 420) -> None:
    """Phase 18 (e): each cell's artifact, per device beside the card's 80
    GB; exits on a cell that fails or outlives `timeout`."""
    for (arch, shape, mesh), t0, proc in procs:
        try:
            out, err = proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dry-run {arch} x {shape} x {mesh}: no result in "
                 f"{timeout} s")
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"dry-run {arch} x {shape} x {mesh}: "
              f"{err[-2000:]}")
        r = json.loads(out[out.index("{"):])
        check(r["status"] == "ok", f"dry-run {arch} x {shape}: {r}")
        cell = (arch, shape, mesh)
        custom = r["op_audit"]["custom"]
        if cell in DRYRUN_CUSTOM_OPS:
            check(custom == DRYRUN_CUSTOM_OPS[cell],
                  f"dry-run {cell}: {custom} kernel operators, want "
                  f"{DRYRUN_CUSTOM_OPS[cell]}")
        check(wall <= DRYRUN_CELL_S.get(cell, timeout),
              f"dry-run {cell}: {wall:.1f} s")
        mem, coll = r["memory"], r["collectives"]
        peak = mem.get("peak_bytes_per_device", -1)
        phase("mesh dryrun", cell=f"{arch} x {shape} x {mesh}",
              devices=r["num_devices"], kind=r["kind"],
              argument_GB=f"{mem['argument_size_in_bytes'] / 1e9:.3f}",
              peak_GB=f"{peak / 1e9:.3f}",
              of_card=f"{peak / CARD_BYTES:.3f}",
              TFLOP=f"{r['cost']['flops'] / 1e12:.3f}",
              collective_GB=json.dumps({k: round(v / 1e9, 4) for k, v in
                                        coll["bytes_by_op"].items()}),
              collective_count=json.dumps(coll["count_by_op"]),
              cross_pod_GB=f"{coll['cross_pod_bytes'] / 1e9:.4f}",
              kernel_ops=custom, ops=r["op_count"],
              trace_seconds=r["trace_seconds"], wall_seconds=f"{wall:.1f}")


def mesh_phase(seed: int) -> dict:
    """Phase 18: the port on the card's host mesh (one device: (data 1,
    model 1)). (a) phase 11's training shape, the state placed by
    `shard_state`, seq_parallel on: two steps, losses and every updated
    leaf bit for bit those of the same steps without a mesh; (b)
    `elastic_remesh` onto a ("data",) mesh, every leaf byte-identical, and
    a third step equal to the unsharded one's; (c) the training CLI with
    its failure drill (degraded restore, rebuild, the restored state
    placed on the mesh again); (d) the serving CLI against the unsharded
    server; (e) three dry-run cells. Exits on a miss; returns the phase's
    launches per kernel."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, layers, uniform_segments
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    dryruns = dryrun_start()
    dev = torch.device("cuda")
    mesh = make_host_mesh()
    cfg = dataclasses.replace(
        get_config("llama3.2-3b"), name=f"llama3.2-3b-{TRAIN['layers']}l",
        segments=uniform_segments("attn", TRAIN["layers"]))
    B, S = TRAIN["batch"], TRAIN["seq"]
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, S, B, seed=0))
    ocfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup_steps"],
                       total_steps=10, clip_norm=TRAIN["clip_norm"])

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_train_state(cfg, gen, dev)

    def run(state, step_fn, steps):
        out = []
        for i in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, *ds.batch(i))
            loss = float(m["loss"])
            out.append((loss, float(m["grad_norm"]),
                        (time.perf_counter() - t0) * 1e3))
        return out

    def leaves_of(state):
        from torch.distributed.tensor import DTensor
        for lst in ([p.data for p in state.params], state.opt["master"],
                    state.opt["m"], state.opt["v"]):
            for t in lst:
                yield t.to_local() if isinstance(t, DTensor) else t

    # (a) two steps without a mesh, then on the host mesh
    tcfg = TrainConfig(accum=TRAIN["accum"], remat=TRAIN["remat"])
    plain = fresh()
    plain_steps = run(plain, make_train_step(cfg, ocfg, tcfg), (0, 1))
    fak.reset_counts()
    sharded = train_cli.shard_state(fresh(), mesh)
    mesh_steps = run(sharded, make_train_step(
        cfg, ocfg, dataclasses.replace(tcfg, seq_parallel=True), mesh=mesh),
        (0, 1))
    flash_mesh = fak.launches
    same = sum(not torch.equal(a, b) for a, b in
               zip(leaves_of(plain), leaves_of(sharded)))
    phase("mesh train", mesh=json.dumps(dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape))),
          layers=cfg.num_layers, batch=B, seq=S, accum=TRAIN["accum"],
          seq_parallel=True,
          losses=json.dumps([f"{x[0]:.6f}" for x in mesh_steps]),
          step_ms=json.dumps([f"{x[2]:.1f}" for x in mesh_steps]),
          unsharded_step_ms=json.dumps([f"{x[2]:.1f}" for x in plain_steps]),
          flash_launches=flash_mesh, leaves_differing=same)
    check([x[:2] for x in mesh_steps] == [x[:2] for x in plain_steps],
          f"sharded losses {mesh_steps} != unsharded {plain_steps}")
    check(same == 0, f"{same} leaves differ after the sharded steps")
    check(flash_mesh == 2 * FLASH_PER_STEP, f"flash launches {flash_mesh}")

    # (b) elastic re-mesh onto ("data",), then a third step
    flat = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    train_cli.elastic_remesh(sharded, flat)
    moved = sum(not torch.equal(a, b) for a, b in
                zip(leaves_of(plain), leaves_of(sharded)))
    third_plain = run(plain, make_train_step(cfg, ocfg, tcfg), (2,))
    third = run(sharded, make_train_step(cfg, ocfg, tcfg, mesh=flat), (2,))
    phase("mesh remesh", to=json.dumps(dict(zip(flat.mesh_dim_names,
                                                flat.shape))),
          leaves_differing=moved, loss=f"{third[0][0]:.6f}",
          step_ms=f"{third[0][2]:.1f}",
          unsharded_step_ms=f"{third_plain[0][2]:.1f}")
    check(moved == 0, f"elastic_remesh changed {moved} leaves")
    check(third[0][:2] == third_plain[0][:2],
          f"step after the re-mesh {third} != {third_plain}")
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the training CLI on the host mesh, with its failure drill
    for k in (gfk, xrk, fak):
        k.reset_counts()
    t0 = time.perf_counter()
    losses = train_cli.run(["--smoke", "--steps", "30", "--batch", "2",
                            "--seq", "64", "--ckpt-every", "10",
                            "--fail-node", "5", "--fail-at", "20",
                            "--log-every", "10", "--mesh"])
    cli = {"gf_bitmatmul": gfk.launches, "xor_reduce": xrk.launches}
    phase("mesh train cli", seconds=f"{time.perf_counter() - t0:.2f}",
          steps=len(losses), first=f"{losses[0]:.4f}",
          last=f"{losses[-1]:.4f}", kernel_launches=json.dumps(cli))
    check(len(losses) == 30 and losses[-1] < losses[0],
          f"training CLI on the mesh: losses {losses[0]} -> {losses[-1]}")
    check(cli["gf_bitmatmul"] > 0 and cli["xor_reduce"] > 0,
          f"the drill's coding kernels: {cli}")

    # (d) the serving CLI on the host mesh against the unsharded server
    args = dict(batch=2, requests=4, prompt_len=16, gen=6, seed=0)
    t0 = time.perf_counter()
    served = serve_cli.run(["--arch", "llama3.2-3b", "--batch", "2",
                            "--requests", "4", "--prompt-len", "16",
                            "--gen", "6", "--mesh"])
    t_mesh = time.perf_counter() - t0
    scfg = get_config("llama3.2-3b", smoke=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    want = serve_cli.serve(scfg, init_params(scfg, gen, dev), device=dev,
                           **args)
    t_plain = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for a, b in zip(served["tokens"],
                                                  want["tokens"]))
    phase("mesh serve cli", seconds=f"{t_mesh:.2f}",
          unsharded_seconds=f"{t_plain:.2f}", tokens_equal=equal)
    check(equal, "the server on the mesh and without it differ")

    # (e) the dry-run cells
    dryrun_finish(dryruns)
    return {"flash_attention": flash_mesh, **cli}


def leaves(node):
    """The tensors of a nested dict / tuple / list tree, in sorted-key
    order."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from leaves(node[key])
    elif isinstance(node, (tuple, list)):
        for item in node:
            yield from leaves(item)
    else:
        yield node


AUTOTUNE_FILE = ROOT / "build" / "autotune_timings.json"
PLANNER_REPS = 20


def planner_phase(code, rand, sms: int, rng) -> dict:
    """Phase 3b (ROADMAP A5): `measure_matmul_tiles` on the card at the
    encode shape and the delta terms, the winners and a hand-written XOR
    entry (half the default grid at S=23, s=20, 1 MiB) saved to
    `AUTOTUNE_FILE`, then both GF shapes and the XOR shape launched through
    `kernels.ops` with `REPRO_TORCH_AUTOTUNE_CACHE` naming the file: plan
    "measured", the host code's plan for that grid equal to it, bytes equal
    to the plain version's. The variable is unset again before returning.
    Returns, per shape, the plan and the device ms under both plans."""
    import numpy as np
    import torch

    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk

    check(autotune.CACHE_ENV not in os.environ,
          f"{autotune.CACHE_ENV} is set before the planner phase")
    autotune.invalidate_plan_cache()
    t0 = time.perf_counter()
    B = MIB
    shapes = {"encode": (np.asarray(code.A, dtype=np.uint8), 8),
              "delta_terms": (rng.integers(1, 256, (21, 1), dtype=np.uint8),
                              1)}
    data = {name: rand(S, M.shape[1], B) for name, (M, S) in shapes.items()}
    entries = {}
    for M, S in shapes.values():
        m, k = M.shape
        entries.update(autotune.measure_matmul_tiles(k, m, B, S=S,
                                                     repeat=PLANNER_REPS))
    AUTOTUNE_FILE.unlink(missing_ok=True)
    xs, xS = 20, 23
    xor_default = autotune.xor_plan(xs, B).grid_steps
    entries[autotune.xor_key(xs, B)] = {"grid_steps": xor_default // 2}
    autotune.save_timings(entries, AUTOTUNE_FILE)
    blocks = rand(xS, xs, B)

    def gf_ms(M, x):
        return time_ms(lambda: ops.apply_matrix_many(M, x), PLANNER_REPS,
                       spin=True)

    def xor_ms():
        return time_ms(lambda: ops.xor_fold_many(blocks), PLANNER_REPS,
                       spin=True)
    default = {name: gf_ms(M, data[name]) for name, (M, _) in shapes.items()}
    default["xor"] = xor_ms()

    out = {}
    os.environ[autotune.CACHE_ENV] = str(AUTOTUNE_FILE)
    autotune.invalidate_plan_cache()
    try:
        for name, (M, S) in shapes.items():
            m, k = M.shape
            x = data[name]
            plan = autotune.plan_matmul_tiles(
                k, m, B, S=S, sms=sms,
                resident=gfk.resident_ctas(m, k, x.device))
            entry = entries[autotune.matmul_key(k, m, B)]
            check(plan.source == "measured"
                  and plan.grid_steps == entry["grid_steps"],
                  f"{name}: plan {plan}, entry {entry}")
            host = gfk.host_plan(S, m, k, B, grid=plan.grid_steps)
            check((host["threads"], host["grid"], host["smem"],
                   host["k_passes"], host["N"]) == (
                       plan.threads, plan.grid_steps, plan.smem_bytes,
                       plan.passes, plan.n_width),
                  f"{name}: host plan {host} != {plan}")
            before = gfk.launches
            got = ops.apply_matrix_many(M, x)
            want = gfk.gf_bitmatmul_plain(
                torch.from_numpy(gf_bit_columns(M)).to(x.device), x)
            torch.cuda.synchronize()
            check(gfk.launches == before + 1 and torch.equal(got, want),
                  f"{name}: the measured plan's launch != plain")
            tuned = gf_ms(M, x)
            b, by = bound_ms(gfk.bound_bytes(S, m, k, B),
                             gfk.bound_ops(S, m, k, B))
            cand = {g: round(t * 1e3, 4)
                    for g, t in entry["candidates"].items()}
            phase(f"planner gf {name}", S=S, m=m, k=k, B=B,
                  candidates_ms=json.dumps(cand),
                  resident_per_sm=host["resident"],
                  plan_source=plan.source, grid_steps=plan.grid_steps,
                  default_grid=autotune.matmul_plan(k, m, B, S=S,
                                                    sms=sms).grid_steps,
                  default_device_ms=f"{default[name]:.4f}",
                  tuned_device_ms=f"{tuned:.4f}",
                  tuned_vs_default=f"{tuned / default[name]:.3f}",
                  bound_ms=f"{b:.4f}", bound_by=by,
                  bound_share_default=f"{b / default[name]:.4f}",
                  bound_share_tuned=f"{b / tuned:.4f}", identical=True)
            out[name] = dict(plan_source=plan.source,
                             grid_steps=plan.grid_steps,
                             default_device_ms=default[name],
                             tuned_device_ms=tuned, candidates_ms=cand)
        plan = autotune.plan_xor_tiles(xs, B, S=xS)
        check(plan.source == "measured"
              and plan.grid_steps == xor_default // 2, f"xor plan {plan}")
        before = xrk.launches
        got = ops.xor_fold_many(blocks)
        want = xrk.xor_reduce_plain(blocks)
        torch.cuda.synchronize()
        check(xrk.launches == before + 1 and torch.equal(got, want),
              "xor: the measured plan's launch != plain")
        tuned = xor_ms()
        b, by = bound_ms(xrk.bound_bytes(xS, xs, B))
        phase("planner xor", S=xS, s=xs, B=B, plan_source=plan.source,
              grid_steps=plan.grid_steps, default_grid=xor_default,
              default_device_ms=f"{default['xor']:.4f}",
              tuned_device_ms=f"{tuned:.4f}",
              tuned_vs_default=f"{tuned / default['xor']:.3f}",
              bound_ms=f"{b:.4f}", bound_by=by,
              bound_share_default=f"{b / default['xor']:.4f}",
              bound_share_tuned=f"{b / tuned:.4f}", identical=True)
        out["xor"] = dict(plan_source=plan.source,
                          grid_steps=plan.grid_steps,
                          default_device_ms=default["xor"],
                          tuned_device_ms=tuned)
    finally:
        del os.environ[autotune.CACHE_ENV]
        autotune.invalidate_plan_cache()
    check(autotune.plan_matmul_tiles(1, 21, B, sms=sms).source == "model",
          "the default plan is not back after the planner phase")
    phase("planner phase", seconds=f"{time.perf_counter() - t0:.2f}",
          timings=str(AUTOTUNE_FILE.relative_to(ROOT)))
    return out


def hazards_phase() -> None:
    """The hazards CLI on the card (its workloads' writes launch the
    coding kernels), against the same workloads written on the CPU: every
    workload OK, ops, waves and violations equal."""
    from repro_torch.analysis import hazards
    from repro_torch.kernels import gf_bitmatmul as gfk

    t0 = time.perf_counter()
    report = ROOT / "build" / "hazards.json"
    report.unlink(missing_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.hazards", "--out",
         str(report)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"hazards CLI: {proc.stdout}{proc.stderr}")
    lines = [ln for ln in proc.stdout.splitlines() if " ops, " in ln]
    card = json.loads(report.read_text())["workloads"]
    cpu = {k: r.to_dict() for k, r in hazards._workload_reports("cpu").items()}
    before = gfk.launches
    again = {k: r.to_dict()
             for k, r in hazards._workload_reports("cuda").items()}
    launched = gfk.launches - before

    def counts(reports):
        return {k: (r["ops"], r["waves"], len(r["violations"]), r["ok"])
                for k, r in reports.items()}
    check(len(lines) == 3 and all(ln.startswith("OK ") for ln in lines),
          f"hazards CLI lines {lines}")
    check(counts(card) == counts(cpu) == counts(again),
          f"hazards: card {counts(card)}, cpu {counts(cpu)}")
    check(launched > 0, "the hazards workloads launched no gf kernel")
    phase("hazards", workloads=json.dumps(counts(card)),
          cli_seconds=f"{cli_s:.2f}", gf_launches_in_process=launched,
          seconds=f"{time.perf_counter() - t0:.2f}")


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
    for kernel, want in (("flash_fwd_sm90_kernel", 3),   # d = 64, 128, 256
                         ("flash_fwd_f32_sm90_kernel", 3),
                         ("flash_decode_sm90_kernel", 3),
                         ("flash_decode_combine_kernel", 3),
                         ("gf_matmul_sm90_kernel", 5)):  # N widths
        spills = ptxas_spills(_build.build_log, kernel)
        phase(f"ptxas {kernel}", functions=len(spills),
              spill_bytes=sum(spills.values()))
        check(len(spills) == want, f"ptxas reported {len(spills)} "
              f"instantiations of {kernel}, want {want}")
        check(not any(spills.values()), f"{kernel} spills {spills}")
    # the fp32 kernel multiplies on the tensor cores: TF32 HMMAs in the
    # SASS of each head dim's instantiation
    sass = sass_opcodes(_build.library_path(), "flash_fwd_f32_sm90_kernel",
                        _build._nvcc())
    hmma = {int(re.search(r"ILi(\d+)E", name).group(1)): tf32_hmma(ops)
            for name, ops in sass.items()}
    phase("sass flash_fwd_f32_sm90_kernel",
          tf32_hmma=json.dumps(dict(sorted(hmma.items()))))
    check(sorted(hmma) == [64, 128, 256] and all(hmma.values()),
          f"TF32 HMMA counts of the fp32 flash kernel: {hmma}")

    from repro_torch.core import decode_plan_cached, make_unilrc
    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.io import TorchBackend
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import gf_bitmatmul as gfk
    from repro_torch.kernels import xor_reduce as xrk

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        got = gfk.gf_bitmatmul(cols, data)  # repro-lint: allow=RA001
        want = gfk.gf_bitmatmul_plain(cols, data)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"gf_bitmatmul != plain at S={S} m={m} k={k} B={B}")
        # the launch the host code plans (C2): autotune.matmul_plan must
        # describe it, field by field
        plan = gfk.host_plan(S, m, k, B)
        tile = autotune.matmul_plan(k, m, B, S=S, sms=sms)
        check((plan["threads"], plan["grid"], plan["smem"], plan["k_passes"],
               plan["N"]) == (tile.threads, tile.grid_steps, tile.smem_bytes,
                              tile.passes, tile.n_width),
              f"matmul_plan {tile} != the kernel's plan {plan}")
        # repro-lint: allow=RA001
        ms = time_ms(lambda: gfk.gf_bitmatmul(cols, data), reps)
        # repro-lint: allow=RA001
        dms = time_ms(lambda: gfk.gf_bitmatmul(cols, data), reps, spin=True)
        pms = time_ms(lambda: gfk.gf_bitmatmul_plain(cols, data), plain_reps)
        b, by = bound_ms(gfk.bound_bytes(S, m, k, B),
                         gfk.bound_ops(S, m, k, B))
        phase("kernel gf_bitmatmul", S=S, m=m, k=k, B=B, offset=offset,
              threads=plan["threads"], grid=plan["grid"], smem=plan["smem"],
              k_passes=plan["k_passes"],
              max_abs_err=err, ms=f"{ms:.4f}", device_ms=f"{dms:.4f}",
              plain_ms=f"{pms:.3f}",
              bound_ms=f"{b:.4f}", bound_by=by, bound_share=f"{b / ms:.4f}",
              pass_bytes=gfk.pass_bytes(S, m, k, B),
              TOP_s=f"{gfk.bound_ops(S, m, k, B) / (ms / 1e3) / 1e12:.1f}",
              GiB_s=f"{S * k * B / GIB / (ms / 1e3):.2f}")
        return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                    bound_ms=b, bound_by=by, bound_share=b / ms)

    def xor_case(S, s, B, reps=10, plain_reps=3, offset=0):
        if offset:
            blocks = rand(S * s * B + offset)[offset:].view(S, s, B)
        else:
            blocks = rand(S, s, B)
        got = xrk.xor_reduce(blocks)  # repro-lint: allow=RA001
        want = xrk.xor_reduce_plain(blocks)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"xor_reduce != plain at S={S} s={s} B={B}")
        # repro-lint: allow=RA001
        ms = time_ms(lambda: xrk.xor_reduce(blocks), reps)
        # repro-lint: allow=RA001
        dms = time_ms(lambda: xrk.xor_reduce(blocks), reps, spin=True)
        pms = time_ms(lambda: xrk.xor_reduce_plain(blocks), plain_reps)
        b, by = bound_ms(xrk.bound_bytes(S, s, B))
        phase("kernel xor_reduce", S=S, s=s, B=B, offset=offset,
              max_abs_err=err, ms=f"{ms:.4f}", device_ms=f"{dms:.4f}",
              plain_ms=f"{pms:.3f}", bound_ms=f"{b:.4f}", bound_by=by,
              GiB_s=f"{xrk.bound_bytes(S, s, B) / GIB / (ms / 1e3):.2f}")
        return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                    bound_ms=b, bound_by=by, bound_share=b / ms)

    def flash_case(B, Hq, Hkv, Sq, Skv, d, dtype, causal, window=0,
                   reps=30, plain_reps=2, tols=None, published=None):
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
                   for sh in ((B, Hq, Sq, d), (B, Hkv, Skv, d),
                              (B, Hkv, Skv, d)))
        if published:
            # a model's narrower heads padded to d (MLA's per-head form):
            # published = (heads, qk, v) of the model's own work; q and k
            # zero past qk, v past v
            _, pqk, pv = published
            for t, w in ((q, pqk), (k, pqk), (v, pv)):
                t[..., w:] = 0

        def kernel():
            return fak.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)

        def plain():
            return fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                 window=window)
        # the route (`fak.is_decode`): bf16 with Hq / Hkv x Sq <= 16 rows
        # launches the split-KV decode kernel, every other call the
        # prefill kernel of its dtype; the counters say which ran
        decode = fak.is_decode(q, k)
        n_split = fak.decode_splits(B * Hkv, Skv, sms) if decode else 0
        before = (fak.launches, fak.decode_launches)
        out, lse = kernel()
        ran = (fak.launches - before[0], fak.decode_launches - before[1])
        want, want_lse = plain()
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        tol, lse_tol = tols or ((2e-2, 2e-2) if bf16 else (2e-5, 1e-4))
        shape = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} d={d} "
                 f"{dtype} causal={causal} window={window}")
        check(ran == (1, int(decode)), f"{shape}: launches (all, decode) "
              f"{ran}, want (1, {int(decode)})")

        def errors(want, want_lse):
            dead = torch.isneginf(want_lse)
            check(torch.equal(torch.isneginf(lse), dead),
                  f"{shape}: rows without a key differ")
            return ((out.float() - want.float()).abs().max().item(),
                    torch.where(dead, 0.0, (lse - want_lse).abs()).max()
                    .item())
        err, lse_err = errors(want, want_lse)
        check(err <= tol and lse_err <= lse_tol,
              f"flash_attention != plain at {shape}: out {err}, lse {lse_err}")
        split = {}
        if decode:
            # and the decode kernel's own algorithm at its own n_split
            s_err, s_lse_err = errors(*fak.flash_decode_plain(
                q, k, v, causal=causal, window=window, n_split=n_split))
            check(s_err <= tol and s_lse_err <= lse_tol,
                  f"decode kernel != flash_decode_plain at {shape}, n_split "
                  f"{n_split}: out {s_err}, lse {s_lse_err}")
            split = dict(n_split=n_split, split_plain_err=s_err,
                         split_plain_lse_err=s_lse_err)
        tail = {}
        if tols and Skv % 128:
            # the bounds' witness: keys padded with zeros to the next
            # 128-key tile, the padding not masked
            kz, vz = (torch.nn.functional.pad(t, (0, 0, 0, -Skv % 128))
                      for t in (k, v))
            bad, bad_lse = fak.flash_attention_fwd_plain(
                q, kz, vz, causal=causal, window=window)
            tail = dict(
                tail_err=(bad.float() - want.float()).abs().max().item(),
                tail_lse_err=(bad_lse - want_lse).abs().max().item())
            del kz, vz, bad, bad_lse
            check(tail["tail_err"] > tol or tail["tail_lse_err"] > lse_tol,
                  f"the bounds at {shape} pass an unmasked key tail: {tail}")
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
        dms = time_ms(kernel, reps, spin=True)
        # the same launch through the operator `torch.ops.repro_torch.
        # flash_attention_fwd` (the dry-run's route): what the
        # dispatcher costs a call, which the wrapper does not pay
        # repro-lint: allow=RA001
        oms = time_ms(lambda: torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, bool(causal), int(window)), reps)
        pms = time_ms(plain, plain_reps)
        lms = time_ms(library, reps)
        ldms = time_ms(library, reps, spin=True)
        ops = fak.bound_flops(B, Hq, Sq, Skv, d, d, causal=causal,
                              window=window)
        # fp32 at fp32 accuracy on the tensor cores: three TF32 products
        # for each product of the function (hi*hi + hi*lo + lo*hi)
        b, by = bound_ms(
            fak.bound_bytes(B, Hq, Hkv, Sq, Skv, d, d, q.element_size()),
            *((ops, BF16_OPS_PER_S) if bf16 else (3 * ops, TF32_OPS_PER_S)))
        pub = {}
        if published:
            ph, pqk, pv = published
            pb, pby = bound_ms(
                fak.bound_bytes(B, ph, ph, Sq, Skv, pqk, pv,
                                q.element_size()),
                fak.bound_flops(B, ph, Sq, Skv, pqk, pv, causal=causal,
                                window=window), BF16_OPS_PER_S)
            pub = dict(published_heads=ph, published_qk=pqk,
                       published_v=pv, published_bound_ms=pb,
                       published_bound_by=pby,
                       published_bound_share=pb / ms,
                       published_device_bound_share=pb / dms)
        phase("kernel flash_decode" if decode else "kernel flash_attention",
              B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
              d=d, dtype=str(dtype).replace("torch.", ""), causal=causal,
              window=window, **{key: (f"{x:.3e}" if isinstance(x, float)
                                      else x) for key, x in split.items()},
              max_abs_err=f"{err:.3e}",
              lse_max_abs_err=f"{lse_err:.3e}", tol_out=tol,
              tol_lse=lse_tol,
              **{key: f"{x:.3e}" for key, x in tail.items()}, ms=f"{ms:.4f}",
              op_ms=f"{oms:.4f}",
              dispatch_us=f"{(oms - ms) * 1e3:.1f}",
              plain_ms=f"{pms:.3f}", library_ms=f"{lms:.4f}",
              bound_ms=f"{b:.4f}", bound_by=by,
              bound_share=f"{b / ms:.4f}", vs_library=f"{ms / lms:.3f}",
              device_ms=f"{dms:.4f}", library_device_ms=f"{ldms:.4f}",
              device_bound_share=f"{b / dms:.4f}",
              device_vs_library=f"{dms / ldms:.3f}",
              TFLOP_s=f"{ops / (ms / 1e3) / 1e12:.1f}",
              **{key: (f"{x:.4f}" if isinstance(x, float) else x)
                 for key, x in pub.items()})
        return dict(max_abs_err=err, ms=ms, op_ms=oms,
                    device_ms=dms, plain_ms=pms,
                    bound_ms=b, bound_by=by, bound_share=b / ms,
                    library_ms=lms, library_device_ms=ldms,
                    lse_max_abs_err=lse_err, **split, **tail, **pub)

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
    # minicpm3's MLA prefill in the per-head form: 40 heads padded to 48,
    # q and k 64 + 32 and v 64 wide, zero-padded to 128
    flash_mla = flash_case(4, 48, 48, 2048, 2048, 128, bf16, True,
                           published=(40, 96, 64))
    # fp32 (3xTF32 on the tensor cores) at d = 128, 64 and 256: a small
    # GQA shape, d = 64, then the llama and recurrentgemma prefill shapes
    flash_fp32 = {
        "B=1 Hq=8 Hkv=2 S=1024 d=128": flash_case(
            1, 8, 2, 1024, 1024, 128, fp32, True, reps=10),
        "B=2 Hq=16 Hkv=4 S=1024 d=64": flash_case(
            2, 16, 4, 1024, 1024, 64, fp32, True, reps=10),
        "B=4 Hq=32 Hkv=8 S=2048 d=128": flash_case(
            4, 32, 8, 2048, 2048, 128, fp32, True, reps=10),
        "B=2 Hq=16 Hkv=1 S=3968 d=256 window=2048": flash_case(
            2, 16, 1, 3968, 3968, 256, fp32, True, window=2048, reps=10)}
    # the model layer's route with fp32 tensors: one fp32 kernel launch
    from repro_torch.models import layers
    q, k, v = (torch.randn(sh, generator=gen, device=dev) for sh in
               ((4, 32, 2048, 128), (4, 8, 2048, 128), (4, 8, 2048, 128)))
    before = (fak.launches, fak.fp32_launches, fak.plain_calls)
    out = layers.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    after = (fak.launches, fak.fp32_launches, fak.plain_calls)
    phase("layer flash_attention fp32", shape=tuple(out.shape),
          counts_before=before, counts_after=after)
    check(after == (before[0] + 1, before[1] + 1, before[2]),
          "layers.flash_attention in fp32: not one fp32 kernel launch")
    check(out.dtype == fp32 and tuple(out.shape) == (4, 32, 2048, 128)
          and bool(torch.isfinite(out).all()), "fp32 layer output")
    del q, k, v, out
    # head dim 256 (recurrentgemma's local attention, MQA): the serve
    # prefill shape, then the 64-key tile's and the 128-row q tile's
    # edges, a window narrower than a key tile, Sq != Skv, one token
    flash_rg = flash_case(2, 16, 1, 3968, 3968, 256, bf16, True,
                          window=2048)
    for S in (63, 64, 65, 127, 128, 129):
        flash_case(1, 16, 1, S, S, 256, bf16, True, reps=10)
    flash_case(1, 16, 1, 300, 300, 256, bf16, True, window=40, reps=10)
    flash_case(1, 16, 1, 1024, 3968, 256, bf16, False, reps=10)
    flash_case(2, 16, 1, 1, 1, 256, bf16, True, reps=10)
    # Kimi K2's MLA prefill in the per-head form at the benchmark cell's
    # shape: 64 heads, q and k 128 + 64 and v 128 wide, zero-padded to 256
    flash_kimi = flash_case(8, 64, 64, 4096, 4096, 256, bf16, True,
                            published=(64, 192, 128))
    # llama-3.2-vision's cross-attention: not causal, the ragged vision
    # length 6404 = 50 x 128 + 4, at prefill (Sq 2048) and decode (Sq 1)
    # (Sq 1 is a decode: the split-KV decode kernel)
    flash_cross = {
        f"B=4 Hq=32 Hkv=8 Sq={Sq} Skv=6404 d=128 non-causal": flash_case(
            4, 32, 8, Sq, 6404, 128, bf16, False, tols=CROSS_TOLS)
        for Sq in (2048, 1)}
    # the decode kernel (bf16, Hq / Hkv x Sq <= 16 rows) beyond the vision
    # decode: the vision heads over Skv 1, 127 and 32768; G = 1 (Hkv = Hq)
    # and 16 (recurrentgemma's 16 / 1 at d = 256); d = 64 and 256; a
    # causal window at Sq = 4 where rows see no key; G x Sq at the cap
    # (G 4, Sq 4). Each against both plain versions, SDPA timed beside;
    # over 1,000 keys and more |out| is ~0.01-0.03, so those cases are held
    # to CROSS_TOLS (the bf16 2e-2 would pass a wrong PV product)
    flash_decode = {"B=4 Hq=32 Hkv=8 Sq=1 Skv=6404 d=128 non-causal":
                    flash_cross["B=4 Hq=32 Hkv=8 Sq=1 Skv=6404 d=128 "
                                "non-causal"]}
    for case in ((4, 32, 8, 1, 1, 128, bf16, False),
                 (4, 32, 8, 1, 127, 128, bf16, False),
                 (4, 32, 8, 1, 32768, 128, bf16, False),
                 (4, 32, 32, 1, 6404, 128, bf16, False),
                 (2, 16, 1, 1, 3968, 256, bf16, False),
                 (4, 32, 8, 1, 6404, 64, bf16, False),
                 (4, 32, 8, 1, 6404, 256, bf16, False),
                 (2, 8, 2, 4, 2, 128, bf16, True, 2),
                 (4, 32, 8, 4, 6404, 128, bf16, False)):
        name = ("B={} Hq={} Hkv={} Sq={} Skv={} d={} ".format(*case[:6])
                + (f"causal window={case[8]}" if case[7] else "non-causal"))
        flash_decode[name] = flash_case(
            *case, reps=10, tols=CROSS_TOLS if case[4] >= 1000 else None)
    # one row group past the cap (G 4, Sq 5: 20 rows): the prefill kernel
    flash_past_cap = flash_case(4, 32, 8, 5, 6404, 128, bf16, False, reps=10,
                                tols=CROSS_TOLS)
    # the flash layer's gradient: kernel forward, blockwise backward
    flash_grad = flash_grad_check(gen, dev)
    faulthandler.cancel_dump_traceback_later()

    # 3b. the launch planner (A5), then the hazards CLI on the card ----------
    faulthandler.dump_traceback_later(300, exit=True)
    planner = planner_phase(code, rand, sms, rng)
    faulthandler.cancel_dump_traceback_later()
    hazards_phase()

    # 4. main path ------------------------------------------------------------
    t0 = time.perf_counter()
    payload = rand(4 * GIB).cpu().numpy()
    phase("payload", bytes=payload.size,
          seconds=f"{time.perf_counter() - t0:.2f}")
    gfk.reset_counts()
    xrk.reset_counts()
    codec, metas, updated = main_path(TorchBackend("cuda"), MIB, payload, rng)
    launches = {"gf_bitmatmul": gfk.launches, "xor_reduce": xrk.launches}
    plain = {"gf_bitmatmul": gfk.plain_calls, "xor_reduce": xrk.plain_calls}
    phase("main path", kernel_launches=json.dumps(launches),
          plain_calls=json.dumps(plain))
    check(all(v > 0 for v in launches.values()), "a kernel never launched")
    check(not any(plain.values()), "a plain version ran on the main path")

    # 7. the serving front-end on phase 4's stripes -----------------------------
    t0 = time.perf_counter()
    frontend = frontend_path(codec, metas, payload, updated, 2505)
    del payload, codec, metas, updated
    gc.collect()
    # the device's cache goes back, so that the serve path runs with the
    # device memory it had before the phase
    torch.cuda.empty_cache()
    pinned = {key: f"{value / 1e9:.3f}" for key, value in
              torch.cuda.host_memory_stats().items()
              if key.endswith(("bytes.current", "bytes.peak"))}
    phase("frontend phase", seconds=f"{time.perf_counter() - t0:.2f}",
          pinned_host_GB=json.dumps(pinned))

    # 6. serve path -------------------------------------------------------------
    flash = serve_path(2505, "llama3.2-3b")

    # 8. the server's entry point at its SMOKE config (head dim 16) ----------
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import layers
    fak.reset_counts()
    layers.reset_blockwise_calls()
    t0 = time.perf_counter()
    smoke = serve_cli.run(["--arch", "llama3.2-3b", "--requests", "1",
                           "--prompt-len", "8", "--gen", "2"])
    smoke_counts = {"launches": fak.launches,
                    "fp32_launches": fak.fp32_launches,
                    "decode_launches": fak.decode_launches,
                    "plain_calls": fak.plain_calls,
                    "blockwise_calls": layers.blockwise_calls}
    phase("serve smoke arch", seconds=f"{time.perf_counter() - t0:.2f}",
          tokens=json.dumps([t.tolist() for t in smoke["tokens"]]),
          flash=json.dumps(smoke_counts))
    check([tuple(t.shape) for t in smoke["tokens"]] == [(1, 2)],
          "smoke serve tokens")
    check(smoke_counts["launches"] == 0 and smoke_counts["plain_calls"] == 0,
          "flash kernel or plain version at head dim 16")
    check(smoke_counts["blockwise_calls"] >= 1, "no blockwise attention")

    # 9. recurrentgemma-9b at full width: rg and local_attn blocks, flash
    # at head dim 256 ------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()        # phase 6's cached device memory goes back
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flash_rg_path = serve_path(2505, "recurrentgemma-9b", tag="rg ")
    pinned = {key: f"{value / 1e9:.3f}" for key, value in
              torch.cuda.host_memory_stats().items()
              if key.endswith(("bytes.current", "bytes.peak"))}
    phase("rg phase", seconds=f"{time.perf_counter() - t0:.2f}",
          pinned_host_GB=json.dumps(pinned))

    # 10. the failure/repair simulator: the chain, a correlated campaign,
    # and data-path repair launching the coding kernels ----------------------
    gc.collect()
    torch.cuda.empty_cache()        # phase 9's cached device memory goes back
    t0 = time.perf_counter()
    sim = sim_path()
    phase("sim phase", seconds=f"{time.perf_counter() - t0:.2f}",
          peak_host_rss_GB=f"{peak_rss_gb():.3f}")

    # 11. training at full width (8 of 28 layers) with the UniLRC
    # checkpoint drill --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_path(2505)
    phase("train phase", seconds=f"{time.perf_counter() - t0:.2f}",
          peak_host_rss_GB=f"{peak_rss_gb():.3f}")
    t0 = time.perf_counter()
    train_witness(2505)
    train_low_lr(2505)
    phase("train witness phase", seconds=f"{time.perf_counter() - t0:.2f}",
          vmrss_GB=f"{vmrss_gb():.3f}")

    # 12. the training entry point at its SMOKE config (head dim 16) --------
    train_cli_phase()

    # 11d. the MLA train witness: minicpm3-4b's full width, 2 layers -------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_witness(2505, "minicpm3-4b", tag="mla ")
    phase("mla train witness phase", seconds=f"{time.perf_counter() - t0:.2f}",
          vmrss_GB=f"{vmrss_gb():.3f}")

    # 13. minicpm3-4b at full width: MLA, the server's default arch ---------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mla_path = serve_path(2505, "minicpm3-4b", tag="mla ")
    phase("mla phase", seconds=f"{time.perf_counter() - t0:.2f}",
          vmrss_GB=f"{vmrss_gb():.3f}")

    # 14. phi3.5-moe at full width, 4 of 32 layers: MoE, flash at d = 128 ---
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moe_path = serve_path(2505, "phi3.5-moe-42b-a6.6b", tag="moe ")
    phase("moe phase", seconds=f"{time.perf_counter() - t0:.2f}",
          vmrss_GB=f"{vmrss_gb():.3f}")

    # 14b. Kimi K2 as one EP32 rank, 4 of 60 layers: MLA at d = 256 beside
    # the dropless routed MoE ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kimi_path = serve_path(2505, "kimi-k2-instruct-ep32", tag="kimi ")
    phase("kimi phase", seconds=f"{time.perf_counter() - t0:.2f}",
          vmrss_GB=f"{vmrss_gb():.3f}")

    # 15-17. the last three block families at full width: rwkv6-7b (no
    # attention), llama-3.2-vision-11b (cross-attention through the flash
    # kernel) and hubert-xlarge (embedding-free, non-causal, encoded) ---
    new_paths = {}
    for arch, tag in (("rwkv6-7b", "rwkv "), ("llama-3.2-vision-11b",
                                              "vision "),
                      ("hubert-xlarge", "hubert ")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new_paths[arch] = serve_path(2505, arch, tag=tag)
        phase(f"{tag}phase", seconds=f"{time.perf_counter() - t0:.2f}",
              vmrss_GB=f"{vmrss_gb():.3f}",
              peak_host_rss_GB=f"{peak_rss_gb():.3f}")
    rwkv_path = new_paths["rwkv6-7b"]
    vision_path = new_paths["llama-3.2-vision-11b"]
    hubert_path = new_paths["hubert-xlarge"]

    # the example programs -----------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    example = examples_phase()

    # 18. the mesh: sharded training and serving on the card's host mesh,
    # elastic re-mesh, and dry-run cells on 256 / 512 fake devices -------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_path = mesh_phase(2505)
    phase("mesh phase", seconds=f"{time.perf_counter() - t0:.2f}",
          vmrss_GB=f"{vmrss_gb():.3f}")

    # 5. results ----------------------------------------------------------------
    fp32_launches = {"serve": flash["fp32_launches"],
                     "serve_smoke": smoke_counts["fp32_launches"],
                     "serve_recurrentgemma": flash_rg_path["fp32_launches"],
                     "serve_minicpm3": mla_path["fp32_launches"],
                     "serve_phi35moe": moe_path["fp32_launches"],
                     "serve_kimi": kimi_path["fp32_launches"],
                     "serve_rwkv6": rwkv_path["fp32_launches"],
                     "serve_vision": vision_path["fp32_launches"],
                     "encode_hubert": hubert_path["fp32_launches"],
                     "example_train": example["fp32_launches"]}
    def prefill(r):       # launches of the bf16 prefill kernel on a path
        return r["launches"] - r["fp32_launches"] - r["decode_launches"]
    decode_by_path = {"serve": flash["decode_launches"],
                      "serve_recurrentgemma": flash_rg_path["decode_launches"],
                      "train": train["flash_decode"],
                      "serve_minicpm3": mla_path["decode_launches"],
                      "serve_phi35moe": moe_path["decode_launches"],
                      "serve_kimi": kimi_path["decode_launches"],
                      "serve_rwkv6": rwkv_path["decode_launches"],
                      "serve_vision": vision_path["decode_launches"],
                      "encode_hubert": hubert_path["decode_launches"],
                      "example_train": example["decode_launches"]}
    kernels = [
        dict(name="gf_bitmatmul", kernel="gf_matmul_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/gf_matmul_sm90.cu",
             replaces="src/repro/kernels/gf_bitmatmul.py:108",
             launches=launches["gf_bitmatmul"],
             launches_by_path={"stripe": launches["gf_bitmatmul"],
                               "frontend": frontend["gf_bitmatmul"],
                               "sim": sim["gf_bitmatmul"],
                               "train": train["gf_bitmatmul"],
                               "serve_minicpm3": mla_path["gf_bitmatmul"],
                               "serve_phi35moe": moe_path["gf_bitmatmul"],
                               "serve_kimi": kimi_path["gf_bitmatmul"],
                               "serve_rwkv6": rwkv_path["gf_bitmatmul"],
                               "serve_vision": vision_path["gf_bitmatmul"],
                               "encode_hubert": hubert_path["gf_bitmatmul"],
                               "train_cli_mesh": mesh_path["gf_bitmatmul"]},
             library_ms=None, **gf_main,
             # the row's shape (encode) under the measured plan of phase
             # 3b; `planned_shapes` has the delta terms too
             plan_source=planner["encode"]["plan_source"],
             grid_steps=planner["encode"]["grid_steps"],
             tuned_device_ms=planner["encode"]["tuned_device_ms"],
             planned_shapes={k: planner[k] for k in ("encode",
                                                     "delta_terms")}),
        dict(name="xor_reduce", kernel="xor_fold_kernel", route="cuda",
             source="src/repro_torch/csrc/coding_kernels.cu",
             replaces="src/repro/kernels/xor_reduce.py:54",
             launches=launches["xor_reduce"],
             launches_by_path={"stripe": launches["xor_reduce"],
                               "frontend": frontend["xor_reduce"],
                               "sim": sim["xor_reduce"],
                               "train": train["xor_reduce"],
                               "serve_minicpm3": mla_path["xor_reduce"],
                               "serve_phi35moe": moe_path["xor_reduce"],
                               "serve_kimi": kimi_path["xor_reduce"],
                               "serve_rwkv6": rwkv_path["xor_reduce"],
                               "serve_vision": vision_path["xor_reduce"],
                               "encode_hubert": hubert_path["xor_reduce"],
                               "train_cli_mesh": mesh_path["xor_reduce"]},
             library_ms=None, **xor_main,
             plan_source=planner["xor"]["plan_source"],
             grid_steps=planner["xor"]["grid_steps"],
             tuned_device_ms=planner["xor"]["tuned_device_ms"],
             planned=planner["xor"]),
        dict(name="flash_attention", kernel="flash_fwd_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/flash_fwd_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=prefill(flash),
             launches_by_path={"serve": prefill(flash),
                               "train": train["flash_attention"],
                               "serve_phi35moe": prefill(moe_path),
                               "serve_minicpm3": prefill(mla_path),
                               "serve_rwkv6": prefill(rwkv_path),
                               "serve_vision": prefill(vision_path),
                               "encode_hubert": prefill(hubert_path),
                               "example_train": prefill(example),
                               "train_mesh": mesh_path["flash_attention"]},
             **flash_main, **flash_grad,
             # the row's numbers are the llama prefill shape's; phase 16's
             # cross-attention prefill shape, with every key of a row, here
             # (its decode shape is the flash_decode row's)
             cross_shapes={name: dict(r, launches=vision_path[
                 "cross_prefill"]) for name, r in flash_cross.items()
                 if "Sq=2048" in name},
             # phase 13's MLA prefill in the per-head form, padded to 128
             mla_shapes={"B=4 Hq=48 Hkv=48 S=2048 d=128 (qk 96, v 64)":
                         dict(flash_mla, launches=prefill(mla_path),
                              per_head_calls=mla_path[
                                  "mla_per_head_calls"])}),
        dict(name="flash_attention_d256", kernel="flash_fwd_sm90_kernel<256>",
             route="cuda", source="src/repro_torch/csrc/flash_fwd_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=prefill(flash_rg_path),
             launches_by_path={"serve_recurrentgemma": prefill(
                 flash_rg_path), "serve_kimi": prefill(kimi_path)},
             **flash_rg,
             # Kimi K2's MLA prefill in the per-head form, padded to 256:
             # phase 3's case at the benchmark cell's shape, with phase
             # 14b's launches and per-head calls (its batches: 4 x 2,048)
             mla_shapes={"B=8 Hq=64 Hkv=64 S=4096 d=256 (qk 192, v 128)":
                         dict(flash_kimi, launches=prefill(kimi_path),
                              per_head_calls=kimi_path[
                                  "mla_per_head_calls"])}),
        # bf16 calls of at most 16 rows a kv head: every cross-attention
        # decode step of phase 16. The row's numbers are the vision decode
        # shape's; `shapes` has phase 3's decode cases, `past_cap` the
        # case one row group past the cap, which ran the prefill kernel
        dict(name="flash_decode", kernel="flash_decode_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/flash_decode_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=sum(decode_by_path.values()),
             launches_by_path=decode_by_path,
             **flash_decode["B=4 Hq=32 Hkv=8 Sq=1 Skv=6404 d=128 "
                            "non-causal"],
             shapes=flash_decode, past_cap=flash_past_cap),
        # fp32 attention at d = 64, 128 and 256: every model config is
        # bf16, so the serve phases (6, 8, 9), which check it, count no
        # fp32 launch; phase 3 checks and times the kernel. The row's
        # numbers are the first shape's; `shapes` has all four, and
        # max_abs_err is the largest of them
        dict(name="flash_attention_fp32", kernel="flash_fwd_f32_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/flash_fwd_f32_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=sum(fp32_launches.values()),
             launches_by_path=fp32_launches,
             **{**next(iter(flash_fp32.values())),
                "max_abs_err": max(r["max_abs_err"]
                                   for r in flash_fp32.values())},
             shapes=flash_fp32),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
