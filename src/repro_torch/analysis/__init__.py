"""Static analysis for the port (copies of `repro.analysis`):

  * `hazards` proves a queued `CodingEngine` flush free of read/write
    ordering hazards before any byte moves;
  * `verify` certifies a (code, placement) pair over GF(2^8) algebra
    alone and emits `certificate` objects, with zero kernel launches;
  * `model` + `schedcheck` model-check the repair scheduler's shared
    transition core (`sim.repair.SchedCore`) over every interleaving of
    bounded scenarios and replay violating traces through the port's
    `Simulator`.

The reference's `lint` needs no copy: it already lints this package.
"""
from __future__ import annotations

from . import certificate, model, schedcheck, verify
from .hazards import (FlushSchedule, HazardReport, HazardViolation, OpAccess,
                      Step, Wave, analyze_flush, check_schedule, check_wave,
                      flush_schedule, op_access, staged_wave)

__all__ = ["FlushSchedule", "HazardReport", "HazardViolation", "OpAccess",
           "Step", "Wave", "analyze_flush", "check_schedule", "check_wave",
           "flush_schedule", "op_access", "staged_wave", "certificate",
           "model", "schedcheck", "verify"]
