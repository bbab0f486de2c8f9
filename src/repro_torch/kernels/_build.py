"""Build and load the CUDA coding kernels (`repro_torch/csrc/*.cu`).

The sources are compiled by `nvcc` for `sm_90a` into one shared library
with a plain C interface and loaded with `ctypes` — no PyTorch headers, so
the build takes seconds. The library lands in `build/repro_torch/` at the
root of the checkout, named by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the file. Nothing here runs at
import time: the first CUDA launch calls `library()`.
"""
from __future__ import annotations

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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCK = threading.Lock()

#: Seconds the last `library()` call spent compiling (0.0 when the library
#: was already built) and the compiler's resource report (`-Xptxas -v`).
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
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprocoding_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.repro_xor_fold.argtypes = [p, p, i64, i64, i64, p]
    lib.repro_xor_fold.restype = ctypes.c_int
    lib.repro_gf_matmul.argtypes = [p, p, p, i64, i64, i64, i64, p]
    lib.repro_gf_matmul.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


_LIB: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library. The first call in a process compiles it
    if no build of the current sources exists; later calls return the
    loaded library without touching the disk (every launch calls this)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            _LIB = _load(str(path))
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
