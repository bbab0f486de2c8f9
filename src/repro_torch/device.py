"""The one rule for where the port runs: CUDA unless the caller asks for
the CPU, and no fallback."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    asking for it without a card raises rather than falling back to the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run on the host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, got {device}")
    return device
