"""Step functions of the port (port of `repro.train`): serving only so
far; the training step comes with the training slice (ROADMAP A9)."""
from .step import make_serve_decode, make_serve_prefill

__all__ = ["make_serve_decode", "make_serve_prefill"]
