"""AdamW with fp32 master weights, cosine schedule, global-norm clipping
(port of `repro.optim.adamw`).

Mixed-precision policy, as in the reference:
  * model params live in bf16 (what the forward consumes),
  * the optimizer keeps fp32 master copies and fp32 m / v moments,
  * the update runs in fp32 and the new params are `master.to(bf16)`,
    every leaf (the reference casts them all, so an fp32 parameter, the
    rg blocks' `lam`, is bf16 after the first step in both packages).

The reference builds new trees each step; the port updates the master
copies, the moments and the model's parameters in place, under
`torch.no_grad()`, tensor by tensor: a second copy of the optimizer state
(14 bytes a parameter with the bf16 weights) would not fit beside the
first at a full-width model's size. Optimizer state is a dict of lists
aligned with the parameter list it was made from, and a host-side int32
step (`"step"`), whose schedule values (`cosine_lr`, the bias
corrections) are computed on the host in fp32, as the reference computes
them on its device.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr. `step` is an
    int or an integer tensor; the result is an fp32 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their fp32 sums of squares (an fp32
    0-d tensor on the tensors' device). A DTensor adds its local shard's
    sum, summed over the mesh dims that split it: nothing is gathered."""
    from torch.distributed.tensor import DTensor
    total = None
    for t in tensors:
        if isinstance(t, DTensor):
            flat = t.to_local().detach().reshape(-1).to(torch.float32)
            sq = _summed_over_shards(torch.dot(flat, flat), t)
        else:
            flat = t.detach().reshape(-1).to(torch.float32)
            sq = torch.dot(flat, flat)
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("global_norm of no tensors")
    if isinstance(total, DTensor):
        total = total.full_tensor()
    return torch.sqrt(total)


def _summed_over_shards(local: torch.Tensor, t) -> torch.Tensor:
    """A per-shard 0-d sum of DTensor t as a 0-d DTensor: partial over the
    mesh dims that split t, replicated over the others."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    pl = [Partial() if isinstance(p, Shard) else Replicate()
          for p in t.placements]
    return DTensor.from_local(local, t.device_mesh, pl, run_check=False)


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> tuple[Sequence[torch.Tensor], torch.Tensor]:
    """Scales `grads` in place by min(1, max_norm / norm) and returns them
    with the norm before clipping. The product is taken in fp32 and cast
    back to each grad's dtype (bf16 grads are rounded, as in the
    reference)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with replicating(grads):
        for g in grads:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
    return grads, norm


def replicating(tensors):
    """Where `tensors` are DTensors, a plain 0-d tensor (the clip scale)
    multiplies them as a replicated one."""
    import contextlib

    from torch.distributed.tensor import DTensor
    if not any(isinstance(t, DTensor) for t in tensors):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def adamw_init(params: Sequence[torch.Tensor]) -> dict:
    """{"master": fp32 copies, "m", "v": fp32 zeros, "step": int32 0} for
    the parameter list `params` (each list in its order)."""
    params = list(params)
    return {
        "master": [p.detach().to(torch.float32, copy=True) for p in params],
        "m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "step": _host(lambda: torch.zeros((), dtype=torch.int32)),
    }


def _host(fn):
    """fn() outside any dispatch mode: the step and its schedule are host
    arithmetic, also while a dry-run traces the step under fake tensors
    (`launch.dryrun`)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return fn()


def bf16_dtensor_parameters(model: torch.nn.Module) -> int:
    """Replace each DTensor parameter of `model` that is not bf16 (the rg
    blocks' fp32 `lam` on a mesh) by a bf16 parameter of its values, in
    every module that holds it, as `models.model.shard_model` places
    parameters; returns how many. `adamw_update` then writes the master
    copy into it in place. It cannot retype a DTensor parameter itself:
    `.data` retypes the wrapper alone, not its local shard and spec, and
    `torch.utils.swap_tensors` refuses a parameter that anything holds a
    weak reference to, as a `MemTracker`'s gradient hooks do in every
    traced train step (`launch.dryrun`)."""
    from torch.distributed.tensor import DTensor
    new = {}
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if not isinstance(p, DTensor) or p.dtype == torch.bfloat16:
                continue
            if id(p) not in new:
                new[id(p)] = torch.nn.Parameter(
                    p.detach().to(torch.bfloat16),
                    requires_grad=p.requires_grad)
            module._parameters[name] = new[id(p)]
    return len(new)


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], opt_state: dict,
                 cfg: AdamWConfig, params: Sequence[torch.Tensor]) -> dict:
    """One AdamW step, in place: clips `grads` (see `clip_by_global_norm`),
    updates `opt_state` ("master", "m", "v" and "step") and writes
    `master.to(bf16)` into `params`. Returns the stats {"lr", "grad_norm"}
    (fp32 0-d tensors). DTensor state (a state on a mesh) is updated
    shard by shard, in place: grads, master copies, moments and parameters
    share their placements, and every DTensor parameter must be bf16
    already (`bf16_dtensor_parameters`)."""
    from torch.distributed.tensor import DTensor
    params = list(params)
    if any(isinstance(p, DTensor) and p.dtype != torch.bfloat16
           for p in params):
        raise TypeError("a DTensor parameter that is not bf16 cannot become "
                        "bf16 in place: replace it first "
                        "(`bf16_dtensor_parameters`)")
    b1, b2 = cfg.b1, cfg.b2

    def schedule():
        step = opt_state["step"] + 1
        sf = step.to(torch.float32)
        # fp32 values, exact as Python floats
        lr = cosine_lr(cfg, step)
        return (step, lr, float(lr), float(1.0 - b1 ** sf),
                float(1.0 - b2 ** sf))
    step, lr, lr_f, c1, c2 = _host(schedule)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    masters, ms, vs = opt_state["master"], opt_state["m"], opt_state["v"]
    if not len(grads) == len(masters) == len(ms) == len(vs) == len(params):
        raise ValueError("grads, optimizer state and params differ in length")
    for g, m, v, w, p in zip(grads, ms, vs, masters, params):
        g = g.to(torch.float32)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
        upd.add_(w, alpha=cfg.weight_decay)
        w.sub_(upd.mul_(lr_f))
        if p.dtype == torch.bfloat16:
            p.copy_(w)
        else:
            p.data = w.to(torch.bfloat16)
    opt_state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}
