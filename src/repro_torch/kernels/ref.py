"""Plain-PyTorch oracles for the coding kernels (port of
`repro.kernels.ref`).

They compute the kernels' functions by other formulations than the
kernels and their plain versions, so a test can hold all of them against
each other. GF(2^8) coding is bit-exact: comparisons are exact equality.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gf import (GF_MUL_TABLE, bitplanes_to_bytes,
                                 bytes_to_bitplanes)

_MUL_TABLE_FLAT = torch.from_numpy(GF_MUL_TABLE.reshape(-1).copy())


def gf_matmul_ref(A: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul by table lookup: A (m, k), data (k, B) uint8 ->
    (m, B) uint8, the XOR over j of MUL[A[i, j], data[j]]."""
    table = _MUL_TABLE_FLAT.to(data.device)
    idx = A.long()[:, :, None] * 256 + data.long()[None, :, :]
    prods = table[idx]                                   # (m, k, B)
    out = prods[:, 0]
    for j in range(1, A.shape[1]):
        out = out ^ prods[:, j]
    return out


def xor_reduce_ref(blocks: torch.Tensor) -> torch.Tensor:
    """XOR-fold s blocks: (s, B) uint8 -> (B,) uint8."""
    out = blocks[0]
    for j in range(1, blocks.shape[0]):
        out = out ^ blocks[j]
    return out


def gf_bitmatmul_ref(a_bits: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Bit-plane formulation on the host: a_bits (8m, 8k) {0,1} from
    `expand_coding_matrix_to_bits`, data (k, B) uint8 -> (m, B) uint8."""
    xb = torch.from_numpy(bytes_to_bitplanes(data.cpu().numpy())).long()
    yb = (torch.from_numpy(np.asarray(a_bits)).long() @ xb) % 2
    return torch.from_numpy(bitplanes_to_bytes(yb.numpy().astype(np.uint8)))
