#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

Drives the port's main path on one CUDA card and checks every byte:

  1. environment: torch, CUDA and nvcc versions, the card's name and
     power limit;
  2. build: the CUDA kernels from `src/repro_torch/csrc/`, compiled by
     nvcc into `build/repro_torch/` at first use;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes and its edges (byte equality for the coding
     kernels; 2e-2 in bf16 and 2e-5 / 1e-4 in fp32 for attention, at head
     dims 64, 128 and 256: recurrentgemma's windowed MQA prefill and the
     64-key tile's edges), with its
     median time over CUDA events, the plain version's time, the bound and
     bound share and, for attention, PyTorch's
     `scaled_dot_product_attention` as a yardstick; ptxas must report 0
     spill bytes for every instantiation of the two sm90 kernels (three
     of the flash kernel, five of the coding kernel);
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
     checked against prefill;
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
  5. a JSON line of per-kernel numbers (five rows: gf, xor, flash d=128,
     flash d=256, and the fp32 flash kernel, which no path runs; gf and
     xor count their launches per path, the simulator's included), the
     card line, and the result line `{"ok": true, "device": {...}}`
     last.

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
import resource
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
# manager's default of 64), and the traffic: requests of prompt + gen
# tokens, `batch` at a time
SERVE_CELLS = {
    "llama3.2-3b": dict(params=3_388_910_592, stripes=36, window=None,
                        batch=4, requests=8, prompt=2048, gen=32),
    # 21,098,541,568 bytes (the 26 rg blocks' `lam` leaves are fp32) in
    # 112 stripes. Windows of 8 stripes: PyTorch's pinned host cache
    # rounds each of the encode double buffer's four buffers up to a power
    # of two and never splits one, so 8-stripe windows reuse the four
    # 2 GiB buffers phase 4 left cached, where 16 would pin 4 x 4 GiB more
    # beside the 24.6 GB store and the 21 GB restore buffer. 3,968 =
    # 31 x 128 prompt tokens (tile-aligned, as the reference's Pallas
    # route wants) past the 2,048-token window, and decode past it too.
    "recurrentgemma-9b": dict(params=10_549_127_680, stripes=112, window=8,
                              batch=2, requests=4, prompt=3968, gen=32),
}


def serve_path(seed: int, arch: str, tag: str = "") -> dict:
    """The serving path of one full-width model (`SERVE_CELLS[arch]`,
    random weights from `seed`): checkpointed as UniLRC 180-of-210 stripes,
    restored degraded after a node loss, rebuilt and served. Checks every
    restored byte, the restore's locality, the flash launches (one per
    attention layer of each prefill batch) and the logits; exits on the
    first failed check. Phase lines are named with `tag` in front. Returns
    the flash kernel's launches and plain calls on the serve run."""
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

    cell = SERVE_CELLS[arch]
    dev = torch.device("cuda")
    cfg = get_config(arch)
    attn_layers = sum(seg.count * sum(kind != "rg" for kind in seg.blocks)
                      for seg in cfg.segments)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    phase(f"{tag}serve init", arch=cfg.name, layers=cfg.num_layers,
          attention_layers=attn_layers, d_model=cfg.d_model,
          q_heads=cfg.num_heads_padded, kv_heads=cfg.num_kv_heads_padded,
          head_dim=cfg.resolved_head_dim, window=cfg.window, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, params=nparams,
          param_count=cfg.param_count(),
          GB=f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f}",
          seconds=f"{time.perf_counter() - t0:.2f}")
    check(nparams == cell["params"], f"{nparams} parameters")

    # 6.1 save: the weights as a 180-of-210 checkpoint, 1 MiB blocks
    store = BlockStore(Topology(num_clusters=10, nodes_per_cluster=24))
    mgr = CheckpointManager(store, make_unilrc(2, 10), block_size=MIB,
                            backend=TorchBackend("cuda"))
    if cell["window"]:
        mgr.codec.max_batch_stripes = cell["window"]
    tree = params_to_tree(model)
    del model
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
    del tree
    rebuilt = mgr.reconstruct_failures()
    check(not store.failed_nodes and rebuilt > 0, f"rebuilt {rebuilt}")
    model = params_from_jax(cfg, restored, dev)
    del restored, mgr, store
    gc.collect()

    # 6.4 serve: requests of prompt + gen tokens, `batch` at a time
    B, P, G, REQ = cell["batch"], cell["prompt"], cell["gen"], cell["requests"]
    fak.reset_counts()
    layers.reset_blockwise_calls()
    torch.cuda.synchronize()
    out = serve(cfg, model, batch=B, requests=REQ, prompt_len=P, gen=G,
                seed=seed, device=dev)
    flash = {"launches": fak.launches, "fp32_launches": fak.fp32_launches,
             "plain_calls": fak.plain_calls,
             "blockwise_calls": layers.blockwise_calls}
    nbatches = math.ceil(REQ / B)
    phase(f"{tag}serve", requests=REQ, batch=B, prompt=P, gen=G,
          seconds=f"{out['seconds']:.3f}",
          tokens_s=f"{out['served_tokens'] / out['seconds']:.1f}",
          generated_tokens_s=f"{REQ * G / out['seconds']:.1f}",
          prefill_ms=",".join(f"{t * 1e3:.2f}" for t in out["prefill_s"]),
          decode_ms_per_token=",".join(f"{t * 1e3 / (G - 1):.3f}"
                                       for t in out["decode_s"]),
          flash=json.dumps(flash))
    check(flash["launches"] == nbatches * attn_layers,
          f"flash launches {flash['launches']} != "
          f"{nbatches} x {attn_layers}")
    check(flash["fp32_launches"] == 0, "fp32 flash kernel on the serve path")
    check(flash["plain_calls"] == 0, "flash plain version on the serve path")
    check(flash["blockwise_calls"] == 0, "blockwise attention on the serve path")
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
    phase(f"{tag}serve check", max_abs_logit=f"{scale:.4f}",
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
        phase(f"{tag}decode split", step_ms=f"{step_ms:.3f}",
              device_ms=f"{device_ms:.3f}",
              device_share=f"{device_ms / step_ms:.4f}",
              device_ops_per_step=sum(c for _, _, c in ops) // NSTEP,
              top=json.dumps([(k[:40], round(ms, 4)) for k, ms, _ in top]))
    except RuntimeError as err:         # the profiler is untried there
        phase(f"{tag}decode split", step_ms=f"{step_ms:.3f}",
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
    phase(f"{tag}prefill split", prefill_ms=f"{prefill_ms:.3f}",
          flash_ms=f"{flash_ms:.3f}", flash_calls=len(events),
          flash_share=f"{flash_ms / prefill_ms:.4f}",
          peak_host_rss_GB=f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.3f}",
          peak_device_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
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
                         ("gf_matmul_sm90_kernel", 5)):  # N widths
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
    flash_fp32 = flash_case(1, 8, 2, 1024, 1024, 128, fp32, True, reps=5)
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
    faulthandler.cancel_dump_traceback_later()

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
          peak_host_rss_GB=f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.3f}")

    # 5. results ----------------------------------------------------------------
    fp32_launches = {"serve": flash["fp32_launches"],
                     "serve_smoke": smoke_counts["fp32_launches"],
                     "serve_recurrentgemma": flash_rg_path["fp32_launches"]}
    kernels = [
        dict(name="gf_bitmatmul", kernel="gf_matmul_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/gf_matmul_sm90.cu",
             replaces="src/repro/kernels/gf_bitmatmul.py:108",
             launches=launches["gf_bitmatmul"],
             launches_by_path={"stripe": launches["gf_bitmatmul"],
                               "frontend": frontend["gf_bitmatmul"],
                               "sim": sim["gf_bitmatmul"]},
             library_ms=None, **gf_main),
        dict(name="xor_reduce", kernel="xor_fold_kernel", route="cuda",
             source="src/repro_torch/csrc/coding_kernels.cu",
             replaces="src/repro/kernels/xor_reduce.py:54",
             launches=launches["xor_reduce"],
             launches_by_path={"stripe": launches["xor_reduce"],
                               "frontend": frontend["xor_reduce"],
                               "sim": sim["xor_reduce"]},
             library_ms=None, **xor_main),
        dict(name="flash_attention", kernel="flash_fwd_sm90_kernel",
             route="cuda", source="src/repro_torch/csrc/flash_fwd_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=flash["launches"] - flash["fp32_launches"],
             launches_by_path={"serve": flash["launches"]
                               - flash["fp32_launches"]},
             **flash_main),
        dict(name="flash_attention_d256", kernel="flash_fwd_sm90_kernel<256>",
             route="cuda", source="src/repro_torch/csrc/flash_fwd_sm90.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=flash_rg_path["launches"]
             - flash_rg_path["fp32_launches"],
             launches_by_path={"serve_recurrentgemma": flash_rg_path[
                 "launches"] - flash_rg_path["fp32_launches"]},
             **flash_rg),
        # fp32 attention: every model config is bf16, so the serve phases
        # (6, 8, 9), which check it, count no fp32 launch; phase 3 checks
        # and times the kernel
        dict(name="flash_attention_fp32", kernel="flash_fwd_kernel",
             route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             launches=fp32_launches["serve"] + fp32_launches["serve_smoke"]
             + fp32_launches["serve_recurrentgemma"],
             launches_by_path=fp32_launches, **flash_fp32),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
