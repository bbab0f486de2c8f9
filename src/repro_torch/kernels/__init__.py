"""Coding kernels of the port: hand-written CUDA for Hopper (sm_90a) in
`repro_torch/csrc/`, each with a plain PyTorch version beside it.

gf_bitmatmul — GF(2^8) coding matmul over a stripe batch (encode, decode,
               non-XOR recovery, delta-update terms).
xor_reduce   — XOR fold over a stripe batch (UniLRC's single-failure
               decode and the gateway pre-fold).

The kernel modules are exported as modules (each holds its wrapper, its
plain version and its launch counters); `ops` holds the public wrappers
and the launch accounting.
"""
from . import gf_bitmatmul, xor_reduce
from .autotune import TilePlan, matmul_plan, plan_stream_windows, xor_plan
from .ops import (KERNEL_LAUNCHES, apply_decode, apply_decode_many,
                  apply_matrix, apply_matrix_many, encode, encode_many,
                  kernel_launch_snapshot, launch_scope, launches_since,
                  recover_many, recover_single, reset_kernel_launch_counts,
                  xor_fold, xor_fold_many)

__all__ = ["TilePlan", "matmul_plan", "plan_stream_windows", "xor_plan",
           "gf_bitmatmul", "xor_reduce", "KERNEL_LAUNCHES", "apply_decode",
           "apply_decode_many", "apply_matrix", "apply_matrix_many",
           "encode", "encode_many", "kernel_launch_snapshot",
           "launch_scope", "launches_since", "recover_many",
           "recover_single", "reset_kernel_launch_counts", "xor_fold",
           "xor_fold_many"]
