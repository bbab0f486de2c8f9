"""Build and load the port's CUDA kernels (`repro_torch/csrc/*.cu`).

Each source is compiled by its own `nvcc` for `sm_90a`, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with `ctypes` — no PyTorch headers, so the build takes
seconds. The library lands in `build/repro_torch/` at the
root of the checkout, named by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the file. Nothing here runs at
import time: the first CUDA launch calls `library()`.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCK = threading.Lock()

#: Seconds the last `library()` call spent compiling (0.0 when the library
#: was already built) and the compiler's resource report (`-Xptxas -v`),
#: kept beside the library and read back when it is reused.
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return str(path)


def _sources() -> list[pathlib.Path]:
    """The translation units: one nvcc each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Named by a hash of the flags and of every file under `csrc/`
    (headers included), so any edit there rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(CSRC)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprocoding_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(_sources(), procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        lib = pathlib.Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS[:1], "-shared", "-o",
                               str(lib), *map(str, objs)],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        log = pathlib.Path(tmp) / "ptxas.log"
        log.write_text("".join(logs))
        os.replace(log, out.with_suffix(".log"))
        os.replace(lib, out)        # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.repro_xor_fold.argtypes = [p, p, i64, i64, i64, i64, p]
    lib.repro_xor_fold.restype = ctypes.c_int
    lib.repro_gf_matmul.argtypes = [p, p, p, i64, i64, i64, i64, i64, p]
    lib.repro_gf_matmul.restype = ctypes.c_int
    lib.repro_gf_plan.argtypes = [i64, i64, i64, i64, i64,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.repro_gf_plan.restype = ctypes.c_int
    for fn in (lib.repro_flash_fwd_f32, lib.repro_flash_fwd_bf16):
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i64, i64,
                       ctypes.c_int, i64, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    lib.repro_flash_decode_bf16.argtypes = [
        p, p, p, p, p, i64, i64, i64, i64, i64, i64, ctypes.c_int, i64,
        ctypes.c_float, p, p, i64, p]
    lib.repro_flash_decode_bf16.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


_LIB: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library. The first call in a process compiles it
    if no build of the current sources exists; later calls return the
    loaded library without touching the disk (every launch calls this)."""
    global _LIB, build_seconds, build_log
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if path.exists():
                build_seconds = 0.0
                log = path.with_suffix(".log")
                build_log = log.read_text() if log.exists() else ""
            else:
                _compile(path)
            _LIB = _load(str(path))
    return _LIB


def stream_handle(device) -> int:
    """The raw handle of `device`'s current CUDA stream: what
    `torch.cuda.current_stream(device).cuda_stream` gives, without building
    a Stream object (12 us of host time a call on an H100 host)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if device.index is None
        else device.index)


def device_guard(device):
    """`torch.cuda.device(device)` for a launch, or nothing to switch where
    `device` is the current device already (5.6 us a call on an H100
    host)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def grid_arg(grid: int | None, name: str) -> int:
    """A C entry's grid argument: 0 (the kernel's default) for None, else
    a positive int, which the entry launches or refuses."""
    if grid is None:
        return 0
    if isinstance(grid, bool) or not isinstance(grid, int) or grid < 1:
        raise ValueError(f"{name}: grid must be None or an int >= 1, "
                         f"got {grid!r}")
    return grid


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
