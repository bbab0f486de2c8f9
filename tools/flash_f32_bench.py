#!/usr/bin/env python3
"""The fp32 flash kernel's dev loop on one CUDA card.

Builds the port's kernel library (from `--src`, the repo's `src/` by
default, so a checkout of another commit can be timed with this script),
prints what ptxas reports for the fp32 flash kernel and the opcodes of its
SASS (`cuobjdump -sass`: the TF32 `HMMA`s, the conversions, the shared
memory loads), then, at the four fp32 shapes of `chip_smoke.py` phase 3,
checks the kernel against its plain version (2e-5 on out, 1e-4 on lse) and
times it (median over CUDA events) beside the plain version,
`scaled_dot_product_attention` and the bound: the function's operations x 3
(three TF32 products per fp32 product) at the dense TF32 rate, or its
bytes at the memory rate. A head dim the checkout's wrapper does not take
prints `raises`. The last line is a JSON object of the results.

`--ablate` instead builds the kernel as it is and variants of it, each
with one piece of work taken out, into `build/flash_f32_ablation/`, and
times them in turns (full, variants, variants reversed, full) at the llama
and recurrentgemma shapes:

  no_lo       only the hi*hi product (a third of the MMAs), splits kept;
  no_split    the raw fp32 bits go to the MMAs as hi and as lo (the
              split's integer and float instructions gone, MMAs kept);
  no_softmax  no max, exp or sum on the score fragment (P = S);

and two that keep the arithmetic and change the warps (`kParts`):

  one_warp    one warp per 16-row group at d = 256 too (4 warps a CTA);
  two_warps   two warps per row group at d = 128 (8 warps a CTA, two CTAs
              an SM, so at most 128 registers a thread).

The ablations give wrong results by construction; only `full` is checked.

`--peak` times a loop of independent `mma.sync` m16n8k8 TF32 products on
register operands (no loads, 8 accumulators a warp, 8 warps a CTA, 4 CTAs
an SM) and prints the TF32 rate that instruction reaches on this card.

Run from the root of the repo, on a machine with a card and nvcc:
    python3 tools/flash_f32_bench.py [--src DIR] [--ablate] [--peak]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import faulthandler
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)

# name: B, Hq, Hkv, S, d, causal, window
SHAPES = {
    "table": (1, 8, 2, 1024, 128, True, 0),
    "d64": (2, 16, 4, 1024, 64, True, 0),
    "llama": (4, 32, 8, 2048, 128, True, 0),
    "recurrentgemma": (2, 16, 1, 3968, 256, True, 2048),
}


def variants(text: str) -> dict[str, str]:
    """The kernel's source and its ablations; each anchor must be found."""
    def sub(pattern: str, repl: str, src: str) -> str:
        new, n = re.subn(pattern, repl, src, flags=re.S)
        if not n:
            raise SystemExit(f"ablation anchor {pattern!r} not found")
        return new

    no_lo = sub(r"\n\s*mma\(s_lo\[j\], a[hl]\[s\][^;]*;", "", text)
    no_lo = sub(r"\n\s*mma\(o\[c\]\[j\], (ph, bl|pl, bh)[^;]*;", "",
                no_lo)
    no_split = sub(r"(void split\(float x, uint32_t& hi, uint32_t& lo\) \{)"
                   r".*?\n\}",
                   r"\1\n  hi = lo = __float_as_uint(x);\n}", text)
    no_softmax = sub(r"(p\[j\]\[e\] = )s <= kNegInf / 2 \? 0\.f : "
                     r"expf\(s - m_run\[e >> 1\]\);", r"\1s;", text)
    parts = r"constexpr int kParts = D == 256 \? 2 : 1;"
    one_warp = sub(parts, "constexpr int kParts = 1;", text)
    two_warps = sub(parts, "constexpr int kParts = D >= 128 ? 2 : 1;", text)
    two_warps = sub(r"__launch_bounds__\(128 \* kParts<D>, 1\)",
                    "__launch_bounds__(128 * kParts<D>, D == 128 ? 2 : 1)",
                    two_warps)
    return {"full": text, "no_lo": no_lo, "no_split": no_split,
            "no_softmax": no_softmax, "one_warp": one_warp,
            "two_warps": two_warps}


def ablate(torch, fak, gen) -> None:
    from repro_torch.kernels import _build
    src = ROOT / "src" / "repro_torch" / "csrc" / "flash_fwd_f32_sm90.cu"
    out_dir = ROOT / "build" / "flash_f32_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src.read_text()).items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        cs.phase(f"build {name}", registers=re.findall(
            r"Used (\d+) registers", log), spill_bytes=sum(
            cs.ptxas_spills(log, "flash_fwd_f32").values()))
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.repro_flash_fwd_f32.argtypes = [
            p, p, p, p, p, i64, i64, i64, i64, i64, i64, ctypes.c_int, i64,
            ctypes.c_float, p]
        libs[name] = lib

    for shape in ("llama", "recurrentgemma"):
        ablate_shape(torch, fak, gen, libs, shape)


def ablate_shape(torch, fak, gen, libs: dict, shape: str) -> None:
    B, Hq, Hkv, S, d, _, window = SHAPES[shape]
    q, k, v = (torch.randn(sh, generator=gen, device="cuda")
               for sh in ((B, Hq, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))

    def call(lib):
        out = torch.empty_like(q)
        lse = torch.empty((B, Hq, S), device=q.device)
        err = lib.repro_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, S, S, d, 1, window,
            ctypes.c_float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out
    want, _ = fak.flash_attention_fwd_plain(q, k, v, window=window)
    err = (call(libs["full"]) - want).abs().max().item()
    cs.check(err <= 2e-5, f"full != plain at {shape}: {err}")
    times: dict[str, list[float]] = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(cs.time_ms(lambda n=name: call(libs[n]), 10))
    for name, ts in times.items():
        cs.phase("ablation", shape=shape, variant=name,
                 ms="/".join(f"{t:.4f}" for t in ts),
                 vs_full=f"{min(ts) / min(times['full']):.3f}")


PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 0x01000193u + i;
  b[0] = a[0] ^ 0x5bd1e995u;
  b[1] = a[1] ^ 0x5bd1e995u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(float* out, int blocks, int iters,
                               void* stream) {
  mma_peak<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                  iters);
  return int(cudaGetLastError());
}
"""


def peak(torch) -> None:
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "flash_f32_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_peak.cu").write_text(PEAK_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / "mma_peak.so"),
                    str(out_dir / "mma_peak.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out_dir / "mma_peak.so"))
    lib.mma_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        err = lib.mma_peak_launch(out.data_ptr(), blocks, iters,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
    ms = cs.time_ms(run, 10)
    flop = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    cs.phase("mma.sync tf32 peak", blocks=blocks, warps_per_block=8,
             ms=f"{ms:.4f}", TFLOP_s=f"{flop / (ms / 1e3) / 1e12:.1f}",
             of_dense_tf32=f"{flop / (ms / 1e3) / cs.TF32_OPS_PER_S:.3f}")


def bench_shape(torch, fak, gen, name: str, reps: int):
    """Check and time the kernel at SHAPES[name]; "raises" if the wrapper
    has no kernel for it."""
    B, Hq, Hkv, S, d, causal, window = SHAPES[name]
    q, k, v = (torch.randn(sh, generator=gen, device="cuda")
               for sh in ((B, Hq, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))

    def kern():
        return fak.flash_attention_fwd(q, k, v, causal=causal, window=window)
    try:
        out, lse = kern()
    except NotImplementedError as exc:
        cs.phase(f"shape {name}", raises=repr(str(exc)[:80]))
        return "raises"
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=window)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    dead = torch.isneginf(lse) & torch.isneginf(want_lse)
    lse_err = torch.where(dead, 0.0, (lse - want_lse).abs()).max().item()
    mask = None
    if window:
        pos = torch.arange(S, device="cuda")
        mask = (pos[:, None] - pos[None] < window) & \
            (pos[:, None] >= pos[None])

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True)
    # in turns: kernel, SDPA, SDPA, kernel
    ms = [cs.time_ms(kern, reps)]
    lms = [cs.time_ms(sdpa, reps), cs.time_ms(sdpa, reps)]
    ms.append(cs.time_ms(kern, reps))
    pms = cs.time_ms(lambda: fak.flash_attention_fwd_plain(
        q, k, v, causal=causal, window=window), 2)
    ops = fak.bound_flops(B, Hq, S, S, d, d, causal=causal, window=window)
    b, by = cs.bound_ms(fak.bound_bytes(B, Hq, Hkv, S, S, d, d, 4),
                        3 * ops, cs.TF32_OPS_PER_S)
    cs.phase(f"shape {name}", B=B, Hq=Hq, Hkv=Hkv, S=S, d=d, window=window,
             max_abs_err=f"{err:.3e}", lse_max_abs_err=f"{lse_err:.3e}",
             ms="/".join(f"{x:.4f}" for x in ms),
             sdpa_ms="/".join(f"{x:.4f}" for x in lms),
             plain_ms=f"{pms:.3f}", bound_ms=f"{b:.4f}", bound_by=by,
             bound_share=f"{b / min(ms):.4f}",
             TFLOP_s=f"{ops / (min(ms) / 1e3) / 1e12:.1f}")
    cs.check(err <= 2e-5 and lse_err <= 1e-4,
             f"{name}: out {err}, lse {lse_err}")
    return dict(max_abs_err=err, lse_max_abs_err=lse_err, ms=ms,
                sdpa_ms=lms, plain_ms=pms, bound_ms=b, bound_by=by,
                bound_share=b / min(ms), GFLOP=ops / 1e9,
                TFLOP_s=ops / (min(ms) / 1e3) / 1e12)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--peak", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fak
    faulthandler.dump_traceback_later(600, exit=True)
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                   "--format=csv,noheader"])
    _build.library()
    cs.phase("build", src=args.src, nvcc_seconds=f"{_build.build_seconds:.2f}",
             card=repr(card))
    kernel = "flash_fwd_f32_sm90_kernel"
    if kernel not in _build.build_log:
        kernel = "flash_fwd_kernel"   # the scalar fp32 kernel it replaced
    for line in _build.build_log.splitlines():
        if kernel in line or "registers" in line:
            print("  ptxas:", line.strip())
    spills = cs.ptxas_spills(_build.build_log, kernel)
    sass = cs.sass_opcodes(_build.library_path(), kernel, _build._nvcc())
    cs.phase("ptxas", kernel=kernel, spill_bytes=json.dumps(spills))
    for name, ops in sass.items():
        top = collections.Counter(ops).most_common(24)
        print(f"[sass {name[-60:]}] total={sum(ops.values())} "
              + " ".join(f"{op}={n}" for op, n in top), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    if args.peak:
        peak(torch)
    if args.ablate:
        ablate(torch, fak, gen)
    if args.peak or args.ablate:
        return
    results = {"card": card, "kernel": kernel, "spill_bytes": spills,
               "tf32_hmma": {n: cs.tf32_hmma(ops) for n, ops in sass.items()},
               "shapes": {}}
    for name in SHAPES:
        results["shapes"][name] = bench_shape(torch, fak, gen, name,
                                              args.reps)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
