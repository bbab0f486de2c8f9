#!/usr/bin/env python3
"""Where the split-KV flash-decode call's time goes, on one CUDA card.

Builds the port's kernel library (`src/repro_torch/csrc/*.cu`), prints
ptxas's registers and spills for `flash_decode_sm90_kernel` and its
combine, then at the decode shapes of llama-3.2-vision's cross-attention
(B=4, Hq=32, Hkv=8, Sq=1, d=128, not causal, Skv 6404 and 32768), for the
wrapper (`flash_attention_fwd`, which launches the decode kernel and its
combine) and for SDPA:

- `ms`: per call, a CUDA-event pair around each call (chip_smoke.py's
  phase 3 `ms`: the host's time in the call counts where it exceeds the
  device's);
- `device_ms`: the same with each call queued behind ~1 ms of device spin,
  so only device time counts (phase 3's `device_ms`);
- `host_us`: the host's wall time per call, over calls enqueued back to
  back with no synchronisation;
- the device kernels each call launches (`torch.profiler`: each kernel's
  mean duration and launches a call).

Phase 3 of chip_smoke.py checks the kernel; this tool only times it.
Run from the root of the repo, on a machine with a card and nvcc:
    python3 tools/flash_decode_bench.py
"""
from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate


def time_ms(fn, reps: int = 50, spin: bool = False) -> float:
    """Median ms of `fn()`, one CUDA-event pair per call; with `spin` each
    call waits behind ~1 ms of device spin (chip_smoke.py's `time_ms`)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_us(fn, reps: int = 200) -> float:
    """Host wall time per call, `reps` calls enqueued back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def kernel_split(fn, reps: int = 20) -> list[tuple[str, float, float]]:
    """(kernel name, mean device us, launches a call) of `fn()` under
    torch.profiler, over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / max(e.count, 1),
             e.count / reps) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fak

    _build.library()
    print(f"[build] seconds={_build.build_seconds:.2f}", flush=True)
    name = None
    for line in _build.build_log.splitlines():
        if "Function properties for" in line:
            name = line.split()[-1]
        if name and "flash_decode" in name and any(
                w in line for w in ("registers", "spill")):
            print(f"  ptxas {name[:60]}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for Skv in (6404, 32768):
        B, Hq, Hkv, Sq, d = 4, 32, 8, 1, 128
        q, k, v = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                   for sh in ((B, Hq, Sq, d), (B, Hkv, Skv, d),
                              (B, Hkv, Skv, d)))
        shape = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} d={d} "
                 f"n_split={fak.decode_splits(B * Hkv, Skv, sms)}")
        bound = fak.bound_bytes(B, Hq, Hkv, Sq, Skv, d, d, 2) \
            / HBM_BYTES_PER_S * 1e3
        for who, fn in (
                ("decode", lambda: fak.flash_attention_fwd(q, k, v,
                                                           causal=False)),
                ("sdpa", lambda: sdpa(q, k, v, enable_gqa=True))):
            ms, dms = time_ms(fn), time_ms(fn, spin=True)
            print(f"[time] {shape} {who}: ms={ms:.4f} device_ms={dms:.4f} "
                  f"host_us={host_us(fn):.1f} bound_ms={bound:.4f} "
                  f"bound_share={bound / ms:.4f} "
                  f"device_bound_share={bound / dms:.4f}", flush=True)
            for key, us, n in kernel_split(fn):
                print(f"[kernels] {shape} {who}: {key[:70]} us={us:.2f} "
                      f"per_call={n:g}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(f"[card] {smi}")


if __name__ == "__main__":
    main()
