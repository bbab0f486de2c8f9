"""PyTorch / CUDA port of the UniLRC reproduction (`repro`).

Layers, bottom up: `topo` (cluster model) → `core` (GF(2^8), codes,
plans, placement) → `kernels` (hand-written Hopper CUDA kernels, their
plain PyTorch versions, launch accounting) → `io` (backends, coalescing
engine) → `ckpt` (block store, stripe codec). The port imports `torch`
and numpy and nothing of the reference package; its tests hold it
against the reference byte for byte.
"""
