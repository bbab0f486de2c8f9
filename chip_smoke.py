#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

Drives the port's main path on one CUDA card and checks every byte:

  1. environment: torch, CUDA and nvcc versions, the card's name and
     power limit;
  2. build: the CUDA kernels from `src/repro_torch/csrc/`, compiled by
     nvcc into `build/repro_torch/` at first use;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (byte equality), with its median time over
     CUDA events, the plain version's time and the bound;
  4. main path: UniLRC 180-of-210 (alpha=2, z=10) on 10 clusters x 24
     nodes, 1 MiB blocks, `TorchBackend("cuda")`: a 4 GiB streamed write
     in windows of 8 stripes, a full read, one node lost (degraded read,
     recovery, rebuild), one cluster lost (21 erasures per stripe) and a
     few delta-parity updates; launch bounds asserted;
  5. a JSON line of per-kernel numbers, the card line, and the result
     line `{"ok": true, "device": {...}}` last.

Any failed check exits non-zero before the result line. Without a CUDA
device, or without the repo's `src/repro_torch` beside it, it exits 1.

Run from the root of the repo:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core rate
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


def bound_ms(nbytes: int, ops: int = 0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repo root")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")

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
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    from repro_torch.core import decode_plan_cached, make_unilrc
    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.io import TorchBackend
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
              bound_ms=f"{b:.4f}", bound_by=by,
              GiB_s=f"{S * k * B / GIB / (ms / 1e3):.2f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by)

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
                    bound_by=by)

    rng = np.random.default_rng(2505)
    gf_main = gf_case(code.A, S_WIN, BS)                       # encode
    gf_case(cluster_plan.M, S_WIN, BS)                         # decode
    for rows, u in ((21, 1), (42, 2), (105, 5)):               # delta terms
        gf_case(rng.integers(1, 256, (rows, u), dtype=np.uint8), 1, BS,
                plain_reps=3)
    gf_case(rng.integers(0, 256, (1, 20), dtype=np.uint8), 3, 3000)
    gf_case(code.A, 2, 4097, offset=1)                         # ragged
    xor_main = xor_case(23, 20, BS)                            # recovery
    xor_case(1, 2, 3001)
    xor_case(4, 29, 4097, offset=3)

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

    # 5. results ----------------------------------------------------------------
    src = "src/repro_torch/csrc/coding_kernels.cu"
    kernels = [
        dict(name="gf_bitmatmul", route="cuda", source=src,
             replaces="src/repro/kernels/gf_bitmatmul.py:108",
             launches=launches["gf_bitmatmul"], library_ms=None, **gf_main),
        dict(name="xor_reduce", route="cuda", source=src,
             replaces="src/repro/kernels/xor_reduce.py:54",
             launches=launches["xor_reduce"], library_ms=None, **xor_main),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
