"""The port stands alone: it loads neither jax nor the reference package,
and its entry points run on CUDA unless the caller asks for the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.ckpt import BlockStore, StripeCodec
from repro_torch.core import make_unilrc
from repro_torch.io import TorchBackend, resolve_backend
from repro_torch.topo import Topology

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if (m.startswith("jax") and sys.modules[m] is not None)
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


def test_default_backend_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_backend(None).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_backend(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        StripeCodec(make_unilrc(1, 6), BlockStore(Topology(6, 8)))
    assert TorchBackend("cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        TorchBackend("meta")
