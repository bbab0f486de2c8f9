"""Byte-path execution for the port: backends (`TorchBackend` on a torch
device, `NumpyBackend` host oracle) and the coalescing `CodingEngine`."""
from .backend import (BACKENDS, Backend, NumpyBackend, TorchBackend,
                      resolve_backend)
from .engine import CodingEngine, FlushStats, OpHandle

__all__ = ["BACKENDS", "Backend", "NumpyBackend", "TorchBackend",
           "resolve_backend", "CodingEngine", "FlushStats", "OpHandle"]
