"""Block kinds: for each, `<kind>.py` says how the benchmark draws the
block's weights in their published layout (`leaves`), checks the port's
configuration (`check_port`), loads the weights into the port's block
(`load`), reads the port's cache of it (`program_cache`) and counts its
work at the published widths (`matmul_weights`, `attention_dims`); a routed
kind also names the port's function that carries its routing (`TAP`),
reads it (`routing`) and says how it spread the load (`load_spread`)."""
from __future__ import annotations

import torch


def padded(w: torch.Tensor, shape: tuple) -> torch.Tensor:
    """w in the leading corner of a zero tensor of `shape` (the port's
    ghost heads are zero)."""
    if tuple(w.shape) == tuple(shape):
        return w
    out = torch.zeros(shape, dtype=w.dtype, device=w.device)
    out[tuple(slice(0, n) for n in w.shape)] = w
    return out
