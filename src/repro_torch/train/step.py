"""Step functions of the port (port of `repro.train.step`): training (loss
+ AdamW) and serving (prefill / decode).

  train_step(state, tokens, labels[, vision])      -> (state, metrics)
  serve_prefill(model, tokens[, vision])           -> (logits_last, cache)
  serve_decode(model, token, cache, pos[, vision]) -> (logits, cache)

`tokens` are (B, S) token ids, or (B, S, D) embeddings for a config
without an embedding table (hubert's stub front end); `vision` is the
(B, vision_seq, D) stub vision input of a `cross_attn` model.

Training, as in the reference:
  * **Microbatching**: with `accum` > 1 the batch is split into `accum`
    microbatches whose bf16 grads are accumulated in fp32 and scaled by
    1 / accum; with `accum` == 1 the bf16 grads go to the optimizer as
    they are.
  * **Remat**: `remat="block"` checkpoints each superblock; flash
    attention keeps its own blockwise backward either way.
  * **Loss**: token-mean cross-entropy of fp32 log-softmax plus the
    model config's `moe.router_aux_weight` x the MoE load-balance loss
    (the NLL alone without an MoE config).

The state is updated in place (the model's bf16 parameters, the fp32
optimizer state, the host-side int32 steps); `train_state_to_tree` and
`train_state_from_jax` carry it to and from the reference's layout, the
tree a checkpoint holds.

On a device mesh (`mesh=`, a state placed by `launch.train.shard_state`)
the parameters and the optimizer state are DTensors, the batch is split
over the batch axes, and the loss is the vocab-parallel NLL of logits
split over `model` (`_nll_on_shards`); a mesh of one device computes what
the unsharded step computes, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (Transformer, forward, init_params,
                                      param_leaves, params_from_jax,
                                      replicating, shard_input, tree_of)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               bf16_dtensor_parameters)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum: int = 1                  # gradient-accumulation microbatches
    remat: str = "none"             # "none" | "block"
    seq_parallel: bool = False      # Megatron SP on the residual stream


@dataclasses.dataclass
class TrainState:
    """The model (bf16 parameters, trainable), the optimizer state
    {"master", "m", "v": fp32 lists aligned with `params`, "step"} and the
    step, an int32 0-d host tensor."""
    model: Transformer
    opt: dict
    step: torch.Tensor

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return list(self.model.parameters())


def init_train_state(cfg: ModelConfig,
                     generator: torch.Generator | None = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """A fresh state: `init_params(cfg, generator, device)`, made
    trainable, with `adamw_init` of its parameters."""
    model = init_params(cfg, generator, device)
    model.requires_grad_(True)
    return TrainState(model=model, opt=adamw_init(model.parameters()),
                      step=torch.zeros((), dtype=torch.int32))


class _TokenNLL(torch.autograd.Function):
    """Token-mean NLL of fp32 log-softmax(logits): the reference's
    `log_softmax(logits.astype(f32))` picked at the labels and averaged,
    with its gradient (softmax - onehot) / N in the logits' dtype. Saves
    the bf16 logits and the fp32 log-sum-exp, so one fp32 copy of the
    logits lives at a time (two inside `logsumexp`), not the three that
    autograd through `log_softmax` keeps."""

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, labels[:, None])[:, 0]
        del lf
        ctx.save_for_backward(logits, labels, lse)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        grad = logits.to(torch.float32, copy=True).sub_(lse[:, None]).exp_()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, labels] -= 1.0
        grad.mul_(g / grad.shape[0])
        return grad.to(logits.dtype), None


class _VocabParallelNLL(torch.autograd.Function):
    """`_TokenNLL` of logits whose vocab is split over a process group:
    each rank holds columns lo .. lo + V_l - 1 of every row. The row max,
    the exp-sum and the picked logit are all-reduced over the group, so
    every rank gets the same token-mean NLL; the gradient, (softmax -
    onehot) / N, needs no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        from repro_torch.models.layers import _reduce
        lf = logits.to(torch.float32)
        mx = _reduce(lf.amax(dim=-1), "max", group)
        lse = _reduce((lf - mx[:, None]).exp_().sum(dim=-1), "sum",
                      group).log_().add_(mx)
        local = labels - lo
        mine = (local >= 0) & (local < lf.shape[-1])
        local = local.clamp(0, lf.shape[-1] - 1)
        picked = torch.where(mine, lf.gather(-1, local[:, None])[:, 0], 0.0)
        del lf
        picked = _reduce(picked, "sum", group)
        ctx.save_for_backward(logits, local, mine, lse)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, local, mine, lse = ctx.saved_tensors
        grad = logits.to(torch.float32, copy=True).sub_(lse[:, None]).exp_()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, local] -= mine.to(grad.dtype)
        grad.mul_(g / grad.shape[0])
        return grad.to(logits.dtype), None, None, None


def _nll_on_shards(logits, labels, mesh):
    """The token-mean NLL of DTensor logits (B, S, V), placed as the
    reference's `cst` leaves them (batch over the batch axes, the vocab
    over `model`), on each device's shards: `_TokenNLL` where the vocab is
    whole, else `_VocabParallelNLL` over `model`; each device's mean is
    weighed by its share of the rows and summed over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import layers as L
    lpl = tuple(logits.placements)
    names = mesh.mesh_dim_names
    split = [mesh.shape[i] for i, p in enumerate(lpl) if p == Shard(0)]
    share = 1.0 / math.prod(split)
    vocab = lpl[names.index("model")] == Shard(2) if "model" in names \
        else False
    r, n = L._axis(mesh, "model") if vocab else (0, 1)
    group = mesh.get_group("model") if n > 1 else None
    bpl = tuple(p if p == Shard(0) else Replicate() for p in lpl)
    opl = tuple(Partial() if p == Shard(0) else Replicate() for p in lpl)

    def nll(lg, lb):
        lg, lb = lg.reshape(-1, lg.shape[-1]), lb.reshape(-1).long()
        out = (_TokenNLL.apply(lg, lb) if n == 1 else
               _VocabParallelNLL.apply(lg, lb, r * lg.shape[-1], group))
        return out if share == 1.0 else out * share
    return L._on_shards(nll, mesh, (logits, labels), (lpl, bpl), opl)


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            tcfg: TrainConfig = TrainConfig(),
            vision: torch.Tensor | None = None, mesh=None):
    """-> (loss, (nll, aux)): nll is the token-mean NLL of the fp32
    log-softmax of the train-mode logits, aux the forward's MoE
    load-balance loss (0 without an MoE block), and the loss
    nll + model.cfg.moe.router_aux_weight x aux (the reference's
    `aux_weight`, 0.01 there and in every MoE config), or the nll alone
    without an MoE config. With a mesh the three are replicated DTensors
    (the batch's reductions done)."""
    logits, _, aux = forward(model, tokens, mode="train", remat=tcfg.remat,
                             vision=vision, mesh=mesh,
                             seq_parallel=tcfg.seq_parallel)
    if mesh is None:
        nll = _TokenNLL.apply(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1).long())
    else:
        from torch.distributed.tensor import Replicate
        nll = _nll_on_shards(logits, shard_input(labels, mesh), mesh)
        rep = [Replicate()] * mesh.ndim
        nll = nll.redistribute(mesh, rep)
        if hasattr(aux, "redistribute"):         # no MoE: a plain zero
            aux = aux.redistribute(mesh, rep)
    moe = model.cfg.moe
    loss = nll if moe is None else nll + moe.router_aux_weight * aux
    return loss, (nll, aux)


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None):
    """Returns train_step(state, tokens, labels, vision=None) -> (state,
    metrics).

    tokens / labels: (B, S) int tensors or numpy arrays (tokens (B, S, D)
    embeddings without an embedding table), vision (B, vision_seq, D) or
    None, all moved to the model's device. With tcfg.accum > 1, B must be
    divisible by accum, and each microbatch takes its rows of tokens,
    labels and vision.
    The state is updated in place and returned; metrics are fp32 0-d
    tensors: loss, nll, aux, lr and grad_norm (before clipping).

    With a mesh the state is placed on it (`launch.train.shard_state`);
    inputs that are not DTensors are split by
    `partitioning.input_sharding_for` (each rank passing the whole batch),
    each device's microbatch is its own rows' share, grads take their
    parameters' placements, and the metrics are plain tensors."""

    def grads_of(state: TrainState, tokens, labels, vision):
        for p in state.params:
            p.grad = None
        loss, (nll, aux) = loss_fn(state.model, tokens, labels, tcfg,
                                   vision, mesh)
        if mesh is not None:
            loss, nll, aux = (_whole(t) for t in (loss, nll, aux))
        with replicating(mesh):
            loss.backward()
        grads = [p.grad for p in state.params]
        for p in state.params:
            p.grad = None
        if mesh is not None:
            grads = [g if g.placements == p.placements else
                     g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, state.params)]
        return loss.detach(), nll.detach(), aux.detach(), grads

    def rows(t, i: int, mb: int):
        """Microbatch i: rows i x mb ... of the batch, or with a mesh the
        same rows of each device's shard."""
        if t is None or mesh is None:
            return None if t is None else t[i * mb:(i + 1) * mb]
        from torch.distributed.tensor import DTensor
        local = t.to_local()
        n = local.shape[0] * mb // t.shape[0]
        return DTensor.from_local(local[i * n:(i + 1) * n], mesh,
                                  t.placements, run_check=False)

    def train_step(state: TrainState, tokens, labels, vision=None):
        dev = state.model.final_norm.device
        tokens = _as_input(tokens, dev)
        labels = _as_input(labels, dev)
        if vision is not None:
            vision = _as_input(vision, dev)
        if mesh is not None:
            tokens, labels = (shard_input(t, mesh) for t in (tokens, labels))
            if vision is not None:
                vision = shard_input(vision, mesh)
        if tcfg.accum == 1:
            loss, nll, aux, grads = grads_of(state, tokens, labels, vision)
        else:
            B = tokens.shape[0]
            if B % tcfg.accum:
                raise ValueError(f"batch {B} is not divisible by accum "
                                 f"{tcfg.accum}")
            mb = B // tcfg.accum
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in state.params]
            loss = nll = aux = torch.zeros((), dtype=torch.float32,
                                           device=dev)
            for i in range(tcfg.accum):
                l_i, n_i, a_i, g_i = grads_of(
                    state, rows(tokens, i, mb), rows(labels, i, mb),
                    rows(vision, i, mb))
                with torch.no_grad():
                    for acc, g in zip(grads, g_i):
                        acc += g.to(torch.float32)
                del g_i
                loss, nll, aux = loss + l_i, nll + n_i, aux + a_i
            inv = 1.0 / tcfg.accum
            with torch.no_grad():
                for g in grads:
                    g.mul_(inv)
            loss, nll, aux = loss * inv, nll * inv, aux * inv
        if mesh is not None:
            # a fp32 leaf becomes bf16, as the unsharded update makes it
            bf16_dtensor_parameters(state.model)
        stats = adamw_update(grads, state.opt, ocfg, state.params)
        del grads
        state.step = state.step + 1
        return state, {"loss": loss, "nll": nll, "aux": aux, **stats}

    return train_step


def _as_input(t, device):
    """An input as a tensor on `device` (a DTensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t if isinstance(t, DTensor) else torch.as_tensor(t, device=device)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered to the whole tensor; a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_state_to_tree(state: TrainState) -> tuple:
    """The reference's `TrainState` as a tree: (params, {"m", "master",
    "step", "v"}, step), which the checkpoint serializer flattens to the
    reference's paths (`0/...`, `1/m/...`, `1/master/...`, `1/step`,
    `1/v/...`, `2`). A snapshot: no leaf aliases the live state, which the
    next step updates in place. Leaves stay on their devices; DTensor
    leaves (a state on a mesh) are gathered whole, so the tree has the
    bytes of the unsharded state's."""
    model = state.model
    index = {id(p): i for i, p in enumerate(state.params)}

    def snapshot(value):
        tree = tree_of(model, value)
        return {k: (v if k == "segments" else v.clone())
                for k, v in tree.items()}
    params = snapshot(lambda p: _whole(p.data))
    opt = {name: snapshot(lambda p, lst=state.opt[name]:
                          _whole(lst[index[id(p)]]))
           for name in ("m", "master", "v")}
    opt["step"] = state.opt["step"].clone()
    return params, opt, state.step.clone()


def train_state_from_jax(cfg: ModelConfig, tree,
                         device: str | torch.device = "cuda") -> TrainState:
    """A `TrainState` on `device` from a tree in the reference's layout:
    the reference's `TrainState` as numpy (its three children), a tree
    that `train_state_to_tree` made, or one a `CheckpointManager` restored
    from either package. A parameter whose leaf is bf16 is bf16 (the rg
    blocks' `lam` is fp32 at init and bf16 after a step, in both
    packages)."""
    device = resolve_device(device)
    params_tree, opt_tree, step = tree
    model = params_from_jax(cfg, params_tree, device)
    for param, leaf, _ in param_leaves(model, params_tree):
        if leaf.dtype == torch.bfloat16 and param.dtype != torch.bfloat16:
            param.data = param.data.to(torch.bfloat16)
    model.requires_grad_(True)
    params = list(model.parameters())
    opt: dict = {}
    for name in ("master", "m", "v"):
        found = {id(p): (t, path) for p, t, path in
                 param_leaves(model, opt_tree[name])}
        opt[name] = []
        for p in params:
            t, path = found[id(p)]
            if tuple(t.shape) != tuple(p.shape) or t.dtype != torch.float32:
                raise ValueError(f"{name}/{'/'.join(path)}: "
                                 f"{tuple(t.shape)} {t.dtype}, want "
                                 f"{tuple(p.shape)} float32")
            opt[name].append(t.to(device=device, copy=True))
    opt["step"] = _int32(opt_tree["step"])
    return TrainState(model=model, opt=opt, step=_int32(step))


def _int32(leaf) -> torch.Tensor:
    """A 0-d int32 host tensor from a step leaf (numpy or tensor)."""
    return torch.tensor(int(leaf), dtype=torch.int32)


def make_serve_prefill(cfg: ModelConfig, mesh=None):
    """serve_prefill(model, tokens, vision=None) -> (last-position logits,
    cache). The cache's sequence capacity equals the prompt length; the
    server pads it to S_max before decode. With a mesh the model is placed
    on it (`models.model.shard_model`) and the outputs are DTensors."""
    def serve_prefill(model, tokens, vision=None):
        logits, cache, _ = forward(model, tokens, mode="prefill",
                                   vision=vision, mesh=mesh)
        return logits[:, -1], cache
    return serve_prefill


def make_serve_decode(cfg: ModelConfig, mesh=None):
    """serve_decode(model, token, cache, pos, vision=None) -> (logits,
    cache): one new token per sequence against a cache filled to `pos`
    (a `cross_attn` block reads its vision keys and values from the
    cache, so `vision` is not needed). With a mesh the cache is placed by
    `partitioning.cache_shardings` (the sequence over `model`)."""
    def serve_decode(model, token, cache, pos: int, vision=None):
        logits, new_cache, _ = forward(model, token, mode="decode",
                                       cache=cache, pos=pos, vision=vision,
                                       mesh=mesh)
        return logits[:, 0], new_cache
    return serve_decode
