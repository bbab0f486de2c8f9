"""Abstract inputs, states and their shardings for each dry-run cell (port
of `repro.launch.specs`).

Abstract here means fake tensors (`torch._subclasses.FakeTensorMode`):
shapes, dtypes and devices, no storage, so a full-width model on a 256- or
512-device mesh is built on any host. They are CPU fake tensors placed as
DTensors on the mesh: rank 0's shards. (The flash layer sends a fake
tensor through the kernel's operator, whatever its device, so the trace
is the card's route.) Every function that makes them enters this module's
one fake mode (`fake_mode`), so tensors of separate calls mix.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import partitioning as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (Transformer, init_cache,
                                      layer_shardings, shard_model)
from repro_torch.optim import adamw_init
from repro_torch.train.step import TrainState

from .shapes import ShapeSpec

_MODE = None


def fake_mode():
    """The process's one `FakeTensorMode` (real inputs allowed: the
    host-side step counters stay real)."""
    global _MODE
    if _MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


def abstract_model(cfg: ModelConfig) -> Transformer:
    """`init_params(cfg)`'s model as fake tensors (its parameters frozen,
    as a served model's are)."""
    with fake_mode():
        return Transformer(cfg, None, "cpu")


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """`init_train_state(cfg)` as fake tensors: the model trainable, fp32
    master / m / v, the steps real host scalars."""
    model = abstract_model(cfg)
    with fake_mode():
        model.requires_grad_(True)
        opt = adamw_init(model.parameters())
    return TrainState(model=model, opt=opt,
                      step=torch.zeros((), dtype=torch.int32))


def train_state_shardings(state: TrainState, mesh) -> dict:
    """Optimizer mirrors param sharding (ZeRO-style: the fp32 master / m /
    v take the (data, model) layout TP + FSDP give the params); the steps
    replicated. {"params", "opt": {"master", "m", "v", "step"}, "step"},
    each list in the order of the state's parameters."""
    psh = layer_shardings(state.model, mesh)
    rep = replicated(mesh)
    return {"params": psh,
            "opt": {"master": psh, "m": psh, "v": psh, "step": rep},
            "step": rep}


def replicated(mesh) -> PT.Sharding:
    return PT.Sharding(mesh, ())


def place_train_state(state: TrainState, mesh) -> TrainState:
    """The state's parameters and optimizer lists as DTensors on `mesh`
    by `train_state_shardings`, in place (a DTensor leaf is gathered
    first: a re-mesh); the host-side steps stay as they are."""
    from torch.distributed.tensor import DTensor
    shard_model(state.model, mesh)
    psh = layer_shardings(state.model, mesh)
    for name in ("master", "m", "v"):
        state.opt[name] = [
            PT.distribute(t.full_tensor() if isinstance(t, DTensor) else t,
                          sh) for t, sh in zip(state.opt[name], psh)]
    return state


def token_inputs(cfg: ModelConfig, B: int, S: int) -> torch.Tensor:
    """The model input (tokens or stub embeddings), fake."""
    with fake_mode():
        if cfg.embed_inputs:
            return torch.empty((B, S), dtype=torch.int32)
        return torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16)


def vision_inputs(cfg: ModelConfig, B: int) -> torch.Tensor | None:
    if cfg.family != "vlm":
        return None
    with fake_mode():
        return torch.empty((B, cfg.vision_seq, cfg.d_model),
                           dtype=torch.bfloat16)


def _placed(t: torch.Tensor, mesh) -> tuple[Any, PT.Sharding]:
    sh = PT.input_sharding_for(mesh, tuple(t.shape))
    with fake_mode():
        return PT.distribute(t, sh), sh


def cell_args(cfg: ModelConfig, spec: ShapeSpec, mesh):
    """-> (kind, args, shardings, donate) for the cell's step function,
    its args fake and already placed on `mesh` by `shardings` (a tree
    of `partitioning.Sharding` over the args: per parameter, in the
    model's order, for a model or a state).

    kind 'train':   train_step(state, tokens, labels[, vision])
    kind 'prefill': serve_prefill(model, tokens[, vision])
    kind 'encode':  forward(model, embeds) (encoder-only prefill)
    kind 'decode':  serve_decode(model, token, cache, pos)
    """
    B, S = spec.global_batch, spec.seq_len

    if spec.kind == "train":
        state = abstract_train_state(cfg)
        with fake_mode():
            place_train_state(state, mesh)
        tokens, tsh = _placed(token_inputs(cfg, B, S), mesh)
        with fake_mode():
            labels = torch.empty((B, S), dtype=torch.int32)
        labels, lsh = _placed(labels, mesh)
        args = [state, tokens, labels]
        shards = [train_state_shardings(state, mesh), tsh, lsh]
        vis = vision_inputs(cfg, B)
        if vis is not None:
            vis, vsh = _placed(vis, mesh)
            args.append(vis)
            shards.append(vsh)
        return "train", tuple(args), tuple(shards), (0,)

    model = abstract_model(cfg)
    with fake_mode():
        shard_model(model, mesh)
    psh = layer_shardings(model, mesh)

    if spec.kind == "prefill":
        tokens, tsh = _placed(token_inputs(cfg, B, S), mesh)
        if not cfg.has_decode:
            return "encode", (model, tokens), (psh, tsh), ()
        args = [model, tokens]
        shards = [psh, tsh]
        vis = vision_inputs(cfg, B)
        if vis is not None:
            vis, vsh = _placed(vis, mesh)
            args.append(vis)
            shards.append(vsh)
        return "prefill", tuple(args), tuple(shards), ()

    if spec.kind == "decode":
        token, tsh = _placed(token_inputs(cfg, B, 1), mesh)
        with fake_mode():
            cache = init_cache(cfg, B, S, device="cpu")
            csh = PT.cache_shardings(cache, mesh)
            cache = _map2(PT.distribute, cache, csh)
        args = (model, token, cache, S - 1)
        shards = (psh, tsh, csh, None)
        return "decode", args, shards, (2,)

    raise ValueError(spec.kind)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of this rank's shard of `t` (a DTensor), or of t."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()


def sharded_bytes(shape: tuple, dtype: torch.dtype,
                  sharding: PT.Sharding) -> int:
    """Bytes of one device's shard of a tensor of `shape` placed by
    `sharding` (every split divides its dim: the rules are guarded)."""
    sizes = PT.axis_sizes(sharding.mesh)
    n = math.prod(shape)
    for ax in sharding.spec:
        if ax is not None:
            n //= math.prod(sizes[a] for a in
                            (ax if isinstance(ax, tuple) else (ax,)))
    return n * torch.empty((), dtype=dtype).element_size()
