#!/usr/bin/env python3
"""Times the GF(2^8) coding kernel (`gf_matmul_sm90_kernel`) on one CUDA card.

Builds the port's kernel library (`src/repro_torch/csrc/*.cu`, as
`chip_smoke.py` does), holds the kernel byte for byte against its plain
PyTorch version on a set of small and edge shapes, then times it in
CUDA-event medians at the stripe path's shapes:

  encode          S=8, 30 x 180 (UniLRC 180-of-210), B = 1 MiB
  cluster decode  S=8, 21 x 180 (one cluster lost), B = 1 MiB
  delta terms     S=1, 21 x 1, 42 x 2, 105 x 5, B = 1 MiB

Beside each time it prints the bound (the larger of the function's bytes
over 3.35 TB/s and its int8 operations over 1,979 TOP/s), the bound share,
the kernel's plan (N width, N tiles, K passes) and the bytes its passes
move beyond the function's, ptxas's registers and spill bytes for every
instantiation, and the card's name and power limit. It does not run the
4 GiB stripe path or the serve path.

Then it builds three variants of the kernel's source, each with one
piece of work taken out, into `build/gf_bench/`, and times them
in turns with the full kernel (full, variants, variants reversed, full)
at the encode and 21 x 1 delta shapes, with the card's SM clock and power
sampled by nvidia-smi beside the encode:

  no_expand    the data bytes go to the tensor cores as they are, without
               the nibble-to-bit expansion;
  no_pack      the epilogue folds the accumulators into one word instead
               of packing parity bytes (and stores nothing);
  no_stores    the epilogue packs as usual but stores nothing.

The variants give wrong results by construction; only the full kernel is
checked.

Run from the root of the repo, on a machine with a card and nvcc:
    python3 tools/gf_bench.py [--reps 20]
"""
from __future__ import annotations

import argparse
import ctypes
import faulthandler
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "gf_matmul_sm90.cu"
OUT = ROOT / "build" / "gf_bench"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core rate
MIB = 1 << 20


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if not smi:
        return "nvidia-smi not found"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    return (out.stdout or out.stderr).strip().splitlines()[0]


def ptxas_report(log: str, kernel: str) -> list[str]:
    """ptxas's lines for every function whose name contains `kernel`, and
    every warning."""
    lines, name = [], None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\S+?)'?(?: for|$)", line)
        if found:
            name = found.group(1)
        if "warning" in line or (name and kernel in name and any(
                w in line for w in ("registers", "spill", "wgmma"))):
            lines.append(f"{name}: {line.strip()}" if name else line.strip())
    return lines


def variants(text: str) -> dict[str, str]:
    """The source and its ablations; each anchor must be found."""
    def sub(pattern: str, repl: str, src: str) -> str:
        new, n = re.subn(pattern, repl, src, flags=re.S)
        if not n:
            raise SystemExit(f"anchor {pattern!r} not in {SRC.name}")
        return new

    no_expand = sub(r"  a\[0\] = nibble_bytes\(v & 0xFu\);.*?"
                    r"a\[3\] = nibble_bytes\(v >> 12\);[^\n]*\n",
                    "  a[0] = v; a[1] = v >> 1; a[2] = v >> 2; a[3] = v >> 3;\n",
                    text)
    no_pack = sub(r"(__device__ __forceinline__ void epilogue\(.*?\{\n)"
                  r".*?\n}\n",
                  r"\1  uint32_t x = 0u;\n#pragma unroll\n"
                  r"  for (int i = 0; i < N / 2; ++i) x ^= d[i];\n"
                  r"  if (x == 0x5a5a5a5au && o.any) *o.at = uint8_t(x ^ t);\n}\n",
                  text)
    no_stores = sub(r"(#pragma unroll\n  for \(int q = 0; q < \(G \+ 3\) / 4; "
                    r"\+\+q\) \{\n    uint8_t\* at = o\.at \+ q \* o\.row_step;\n"
                    r"    if \()o\.any",
                    r"\1old[q] == 0x5a5a5a5au && o.any", text)
    return {"full": text, "no_expand": no_expand, "no_pack": no_pack,
            "no_stores": no_stores}


def build_variants(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One library per variant, built in parallel."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in srcs.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(SRC.parent), "-shared", "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        print(f"[build {name}] spill_bytes_per_function={spills}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.repro_gf_matmul.argtypes = [p, p, p, i64, i64, i64, i64, i64,
                                        p]
        lib.repro_gf_matmul.restype = ctypes.c_int
        libs[name] = lib
    return libs


def sample_clocks(stop: threading.Event, out: list[str]) -> None:
    smi = shutil.which("nvidia-smi")
    while smi and not stop.is_set():
        got = subprocess.run([smi, "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=False)
        out.append(got.stdout.strip())
        time.sleep(0.25)


def launcher(lib: ctypes.CDLL, cols, data, out, stream: int):
    """One launch of a variant's kernel on these operands."""
    S, k, B = data.shape
    m = cols.shape[0]

    def run() -> None:
        err = lib.repro_gf_matmul(cols.data_ptr(), data.data_ptr(),
                                  out.data_ptr(), S, m, k, B, 0, stream)
        if err:
            raise SystemExit(f"CUDA error {err}")
    return run


def ablate(shapes, operands, time_ms, reps: int) -> None:
    """Time the variants in turns with the full kernel at each shape."""
    import torch
    libs = build_variants(variants(SRC.read_text()))
    order = list(libs) + list(reversed(libs))
    for name, M, S in shapes:
        m, k = M.shape
        cols, data = operands(M, S, MIB)
        out = torch.empty((S, m, MIB), dtype=torch.uint8, device=data.device)
        stream = torch.cuda.current_stream().cuda_stream
        times: dict[str, list[float]] = {v: [] for v in libs}
        stop, clocks = threading.Event(), []
        sampler = threading.Thread(target=sample_clocks, args=(stop, clocks))
        if name == "encode":
            sampler.start()
        for variant in order:
            run = launcher(libs[variant], cols, data, out, stream)
            times[variant].append(time_ms(run, reps)[0])
        stop.set()
        if sampler.is_alive():
            sampler.join()
        print(f"[ablate {name}] S={S} m={m} k={k} B={MIB} " + " ".join(
            f"{v}_ms={','.join(f'{t:.4f}' for t in ts)}"
            for v, ts in times.items())
            + (f" clocks_power={clocks[:6]}" if clocks else ""), flush=True)
        del cols, data, out
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool times the kernel on a card")

    from repro_torch.core import decode_plan_cached, make_unilrc
    from repro_torch.core.gf import gf_bit_columns
    from repro_torch.kernels import _build
    from repro_torch.kernels import gf_bitmatmul as gfk

    # a broken mbarrier ring hangs the card (the kernel has no timeout of
    # its own): end the process with a traceback instead of waiting
    faulthandler.dump_traceback_later(300, exit=True)
    print(f"[card] {card_line()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    _build.library()
    print(f"[build] nvcc_seconds={_build.build_seconds:.2f}", flush=True)
    for line in ptxas_report(_build.build_log, "gf_matmul_sm90_kernel"):
        print("  ptxas:", line, flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2505)
    code = make_unilrc(alpha=2, z=10)
    cluster = decode_plan_cached(code, code.groups[0]).M

    def operands(M, S, B, offset=0):
        cols = torch.from_numpy(gf_bit_columns(M)).to(dev)
        k = M.shape[1]
        flat = torch.from_numpy(rng.integers(0, 256, S * k * B + offset,
                                             dtype=np.uint8)).to(dev)
        return cols, flat[offset:].view(S, k, B)

    def rand_matrix(m, k):
        return rng.integers(0, 256, (m, k), dtype=np.uint8)

    # byte equality first: edge shapes, every width, passes and N tiles
    checks = [(code.A, 2, 4096, 0), (cluster, 2, 4096, 0),
              (rand_matrix(21, 1), 1, 4096, 0), (rand_matrix(42, 2), 1, 4096, 0),
              (rand_matrix(105, 5), 1, 4096, 0), (rand_matrix(1, 20), 3, 3000, 0),
              (rand_matrix(1, 1), 1, 1, 0), (rand_matrix(1, 1), 2, 200, 0),
              (code.A, 2, 4097, 1), (rand_matrix(17, 33), 2, 1000, 0),
              (rand_matrix(40, 9), 1, 160, 0), (code.A, 36, 256, 0),
              (rand_matrix(8, 64), 2, 777, 3), (rand_matrix(16, 255), 2, 300, 0)]
    for M, S, B, offset in checks:
        cols, data = operands(M, S, B, offset)
        got = gfk.gf_bitmatmul(cols, data)  # repro-lint: allow=RA001
        want = gfk.gf_bitmatmul_plain(cols, data)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        print(f"[check] S={S} m={M.shape[0]} k={M.shape[1]} B={B} "
              f"offset={offset} plan={gfk.kernel_plan(*M.shape)} "
              f"bytes_wrong={bad}", flush=True)
        if bad:
            raise SystemExit("FAIL: the kernel differs from the plain version")

    def time_ms(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times), min(times), max(times)

    shapes = [("encode", code.A, 8), ("cluster_decode", cluster, 8),
              ("delta_21x1", rand_matrix(21, 1), 1),
              ("delta_42x2", rand_matrix(42, 2), 1),
              ("delta_105x5", rand_matrix(105, 5), 1)]
    for name, M, S in shapes:
        m, k = M.shape
        cols, data = operands(M, S, MIB)
        got = gfk.gf_bitmatmul(cols, data)  # repro-lint: allow=RA001
        if name.startswith("delta") or name == "encode":
            want = gfk.gf_bitmatmul_plain(cols, data)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"FAIL: {name} differs from the plain version")
        del got
        ms, lo, hi = time_ms(
            # repro-lint: allow=RA001
            lambda cols=cols, data=data: gfk.gf_bitmatmul(cols, data),
            args.reps)
        nbytes = gfk.bound_bytes(S, m, k, MIB)
        ops = gfk.bound_ops(S, m, k, MIB)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT8_OPS_PER_S * 1e3
        bound, by = (t_ops, "operations") if t_ops > t_bytes else \
            (t_bytes, "bytes")
        extra = gfk.pass_bytes(S, m, k, MIB)
        print(f"[time {name}] S={S} m={m} k={k} B={MIB} ms={ms:.4f} "
              f"min={lo:.4f} max={hi:.4f} reps={args.reps} "
              f"bound_ms={bound:.4f} bound_by={by} "
              f"bound_share={bound / ms:.4f} "
              f"TOP_s={ops / (ms / 1e3) / 1e12:.1f} "
              f"pass_bytes={extra} "
              f"bytes_bound_with_passes_ms="
              f"{(nbytes + extra) / HBM_BYTES_PER_S * 1e3:.4f} "
              f"plan={gfk.kernel_plan(m, k)}", flush=True)
        del cols, data
        torch.cuda.empty_cache()
    ablate([shapes[0], shapes[2]], operands, time_ms, args.reps)
    print(f"[card] {card_line()}", flush=True)


if __name__ == "__main__":
    main()
