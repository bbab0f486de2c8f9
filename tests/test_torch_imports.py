"""The port stands alone: it loads neither jax nor the reference package,
and its entry points run on CUDA unless the caller asks for the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.ckpt import BlockStore, CheckpointManager, StripeCodec
from repro_torch.configs import get_config
from repro_torch.core import make_unilrc
from repro_torch.io import TorchBackend, resolve_backend
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import init_cache, init_params, layers
from repro_torch.topo import Topology
from repro_torch.train import init_train_state

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# The modules each slice added; the probe below imports every module of
# the package, these must be among them.
SLICE_MODULES = [
    "repro_torch.topo.network", "repro_torch.core.metrics",
    "repro_torch.core.mttdl", "repro_torch.ckpt.stripe",
    "repro_torch.ckpt.store", "repro_torch.ckpt.manager",
    "repro_torch.priority", "repro_torch.io.cache",
    "repro_torch.analysis", "repro_torch.analysis.hazards",
    "repro_torch.io.engine", "repro_torch.io.backend",
    "repro_torch.io.frontend", "repro_torch.io.workload",
    "repro_torch.configs.recurrentgemma_9b", "repro_torch.models.layers",
    "repro_torch.sim", "repro_torch.sim.events", "repro_torch.sim.failures",
    "repro_torch.sim.repair", "repro_torch.sim.montecarlo",
    "repro_torch.analysis.certificate", "repro_torch.analysis.model",
    "repro_torch.analysis.verify", "repro_torch.analysis.schedcheck",
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.compress",
    "repro_torch.train", "repro_torch.train.step",
    "repro_torch.launch.train", "repro_torch.configs.phi4_mini_38b",
    "repro_torch.configs.qwen15_32b", "repro_torch.configs.minicpm3_4b",
    "repro_torch.configs.phi35_moe_42b_a66b",
    "repro_torch.configs.kimi_k2_1t_a32b",
]

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
missing = sorted(set(SLICE) - set(names) - {"repro_torch"})
print(len(names), bad, missing)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    probe = f"SLICE = {SLICE_MODULES!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, rest = out.stdout.split(" ", 1)
    assert int(count) >= 50
    assert rest.strip() == "[] []"


_EXAMPLES_PROBE = r"""
import importlib.util, pathlib, sys
sys.modules["jax"] = None            # any `import jax` now raises
for path in sorted(pathlib.Path(EXAMPLES).glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    print(path.stem)
bad = sorted(m for m in sys.modules
             if (m.startswith("jax") and sys.modules[m] is not None)
             or m == "repro" or m.startswith("repro."))
print(bad)
"""


def test_examples_import_no_jax_and_no_reference():
    """The example ports (`examples/*_torch.py`) load with jax blocked and
    pull in nothing of the reference package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    probe = f"EXAMPLES = {str(SRC.parent / 'examples')!r}\n" + \
        _EXAMPLES_PROBE
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["quickstart_torch", "serving_torch",
                                  "train_with_failures_torch", "[]"]


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


def test_model_and_server_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("llama3.2-3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(["--arch", "llama3.2-3b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(BlockStore(Topology(4, 8)), make_unilrc(1, 4))
    assert init_params(cfg, device="cpu").embed.device.type == "cpu"


def test_layers_default_to_cuda():
    cfg = get_config("llama3.2-3b", smoke=True)
    if torch.cuda.is_available():
        assert layers.SwiGLU(8, 16).w_gate.device.type == "cuda"
        assert layers.Attention(cfg).wq.device.type == "cuda"
        return
    # torch built without CUDA asserts, one with CUDA but no card raises
    with pytest.raises((AssertionError, RuntimeError)):
        layers.SwiGLU(8, 16)
    with pytest.raises((AssertionError, RuntimeError)):
        layers.Attention(cfg)
    assert layers.SwiGLU(8, 16, device="cpu").w_gate.device.type == "cpu"
    assert layers.Attention(cfg, device="cpu").wq.device.type == "cpu"


def test_training_defaults_to_cuda_and_never_falls_back():
    """Nothing trains on the CPU unless asked: the CLI and the state's
    constructor raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("llama3.2-3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.run(["--smoke", "--steps", "1"])
    state = init_train_state(cfg, device="cpu")
    assert state.model.embed.device.type == "cpu"
    assert all(p.requires_grad for p in state.params)
