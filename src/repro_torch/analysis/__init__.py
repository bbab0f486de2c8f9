"""Static analysis for the port: `hazards` proves a queued `CodingEngine`
flush free of read/write ordering hazards before any byte moves (a copy of
`repro.analysis.hazards`)."""
from .hazards import (FlushSchedule, HazardReport, HazardViolation, OpAccess,
                      Step, Wave, analyze_flush, check_schedule, check_wave,
                      flush_schedule, op_access, staged_wave)

__all__ = ["FlushSchedule", "HazardReport", "HazardViolation", "OpAccess",
           "Step", "Wave", "analyze_flush", "check_schedule", "check_wave",
           "flush_schedule", "op_access", "staged_wave"]
