"""Static analysis for the port (copies of `repro.analysis`):

  * `hazards` proves a queued `CodingEngine` flush free of read/write
    ordering hazards before any byte moves;
  * `verify` certifies a (code, placement) pair over GF(2^8) algebra
    alone and emits `certificate` objects, with zero kernel launches;
  * `model` + `schedcheck` model-check the repair scheduler's shared
    transition core (`sim.repair.SchedCore`) over every interleaving of
    bounded scenarios and replay violating traces through the port's
    `Simulator`.
  * `lint` checks the port's own source against its repo invariants
    (raw kernel calls, float GF arrays, counter writes, hard-coded launch
    shapes, ...); stdlib only, loaded on first attribute access, so that
    `python -m repro_torch.analysis.lint` finds it unloaded.
"""
from __future__ import annotations

from typing import Any

from . import certificate, model, schedcheck, verify
from .hazards import (FlushSchedule, HazardReport, HazardViolation, OpAccess,
                      Step, Wave, analyze_flush, check_schedule, check_wave,
                      flush_schedule, op_access, staged_wave)

__all__ = ["FlushSchedule", "HazardReport", "HazardViolation", "OpAccess",
           "Step", "Wave", "analyze_flush", "check_schedule", "check_wave",
           "flush_schedule", "op_access", "staged_wave", "certificate",
           "lint", "model", "schedcheck", "verify"]


def __getattr__(name: str) -> Any:
    if name == "lint":
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
