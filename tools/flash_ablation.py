#!/usr/bin/env python3
"""Where the bf16 flash kernel's time goes, by ablation, on one CUDA card.

Builds `src/repro_torch/csrc/flash_fwd_sm90.cu` as it is and three variants
of it, each with one piece of work taken out, into separate libraries
under `build/flash_ablation/`, and times them against each other in turns
(full, variants, variants reversed, full) at the llama serving prefill
shape (B=4, Hq=32, Hkv=8, S=2048, causal) and at llama-3.2-vision's
cross-attention prefill (Sq=2048 over Skv=6404 vision keys, not causal):

  no_p_lo     PV without the P_lo product (P rounded to bf16: 2/3 of the
              tensor-core work);
  no_softmax  no max, exp or sum on the score fragment (P = S);
  no_loads    the producer fills the K/V ring once per CTA and then only
              signals it, so no K/V bytes move after the first stages.

The no_softmax and no_loads variants give wrong results by construction;
`full` is checked against the plain version, and `full` and `no_p_lo`
print their largest error against it (out and lse): what rounding P to
bf16 costs. Also prints each build's ptxas spill bytes,
`scaled_dot_product_attention`'s time at the same shapes, and the card's
name, power limit and SM clock.

Run from the root of the repo, on a machine with a card and nvcc:
    python3 tools/flash_ablation.py
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_fwd_sm90.cu"
OUT = ROOT / "build" / "flash_ablation"


def variants(text: str) -> dict[str, str]:
    """The source and its ablations; each anchor must be found."""
    def sub(pattern: str, repl: str, src: str) -> str:
        new, n = re.subn(pattern, repl, src, flags=re.S)
        if not n:
            raise SystemExit(f"anchor {pattern!r} not in {SRC.name}")
        return new

    no_lo = sub(r"wgmma_rs<D>\(o, plo\[[^;]*;", "", text)
    no_softmax = sub(r"  const float scale_log2 = scale \* kLog2e;.*?\n}\n",
                     "  corr[0] = corr[1] = 1.f;\n}\n", text)
    no_loads = text
    for op in ("k", "v"):
        no_loads = sub(
            rf"(\n\s*)(mbar_expect_tx\(bars\.full_{op}\(s\), L::kKVTile\);"
            rf".*?&tm_{op}, [^;]*;)",
            rf"\1if (r < kStages) {{ \2 }} else {{ "
            rf"mbar_arrive(bars.full_{op}(s)); }}", no_loads)
    return {"full": text, "no_p_lo": no_lo, "no_softmax": no_softmax,
            "no_loads": no_loads}


def build(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in srcs.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(SRC.parent), "-shared", "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
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
        lib.repro_flash_fwd_bf16.argtypes = [p, p, p, p, p, i64, i64, i64, i64,
                                             i64, i64, ctypes.c_int, i64,
                                             ctypes.c_float, p]
        libs[name] = lib
    return libs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fak
    libs = build(variants(SRC.read_text()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def call(lib, q, k, v, causal):
        B, Hq, Sq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((B, Hq, Sq), device=dev)
        err = lib.repro_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, k.shape[1], Sq, k.shape[2], d,
            int(causal), 0, ctypes.c_float(d ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out, lse

    def time_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
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

    for B, Hq, Hkv, Sq, Skv, causal in ((4, 32, 8, 2048, 2048, True),
                                        (4, 32, 8, 2048, 6404, False)):
        q, k, v = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                   for sh in ((B, Hq, Sq, 128), (B, Hkv, Skv, 128),
                              (B, Hkv, Skv, 128)))
        shape = f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} causal={causal}"
        want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal)
        for name in ("full", "no_p_lo"):
            out, lse = call(libs[name], q, k, v, causal)
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            print(f"[ablation error] {shape} variant={name} "
                  f"max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e}",
                  flush=True)
            if name == "full" and err > 2e-2:
                raise SystemExit(f"full != plain: {err}")
        del want, want_lse, out, lse
        order = list(libs) + list(libs)[::-1]
        times: dict[str, list[float]] = {name: [] for name in libs}
        for name in order:
            times[name].append(time_ms(lambda n=name: call(libs[n], q, k, v,
                                                           causal)))
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        flops = fak.bound_flops(B, Hq, Sq, Skv, 128, 128, causal=causal)
        for name, ts in times.items():
            print(f"[ablation] {shape} variant={name} "
                  f"ms={','.join(f'{t:.4f}' for t in ts)} "
                  f"TFLOP_s={flops / min(ts) / 1e9:.1f}", flush=True)
        print(f"[ablation] {shape} sdpa_ms={lib_ms:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(f"[card] {smi}")


if __name__ == "__main__":
    main()
