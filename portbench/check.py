"""The check that decides `correct`: what the timed prefill handed on,
against the plain reference (`portbench/reference/`) in float32.

The numbers, each held to the limit of the cell's `limits/<cell>.json`
(which names the ones the cell compares):

- `cache_err`: for each compared prompt, each layer and each cache leaf,
  the median over positions of |program - reference| / |reference| per
  position (a vector norm over the leaf's features); the worst of these.
  Every position of every layer of every compared prompt is read. It
  sees an error spread over the prompt that is small at each position.
- `cache_err_max`: the same per-position error at its worst position, of
  any compared prompt, layer and leaf. It sees a fault that touches a few
  positions only, such as a cache write that is wrong past some tile:
  the logits do not, since the prefill attends over fresh keys and values
  and not over the cache it hands on.
- `logit_err`: the widest |program - reference| / |reference| of a
  compared prompt's last-position logits.
- `token_gap`: the widest gap, over compared prompts, by which the
  reference's logit of the token the program serves first lies below the
  reference's best, in units of the standard deviation of the reference's
  logits of that prompt.
- `route_gap` (routed block kinds): routing is discontinuous, and a
  token whose router probabilities nearly tie goes to one expert in
  bfloat16 and another in float32; on random weights such switches
  compound with depth. So the reference follows the program's routing
  decisions, which experts each token took and which tokens each expert
  kept, and this number is the widest margin by which one of those
  decisions departs from the reference's own (`reference/attn_moe.route`).
  The decisions are read from a replay of each compared batch through
  the program with its `top_k` tapped, after the window.
- `replay_diff` (routed block kinds): output tensors of that replay that
  differ in any bit from what the timed batch handed on; 0, or the
  decisions followed were not the timed path's.

A non-finite output reads as infinity. The reference reads the program's
outputs only to judge them.
"""
from __future__ import annotations

import torch

from .inputs import block_module
from .reference.model import Forward
from .reference.precision import FP8, FP32, full_fp32


class ProgramOutputs:
    """The kept batches of the window, each a dict: "prompts", "logits",
    "tokens", "cache" (the port's layout), and for a routed block kind
    "routing" (per layer, or None if it could not be read) and
    "replay_diff"."""

    def __init__(self, config: dict, kept: list[dict]):
        self.config = config
        self.kind = block_module(config["block_kind"])
        self.prompts = torch.cat([k["prompts"] for k in kept])
        self.logits = torch.cat([k["logits"] for k in kept]).float()
        self.tokens = torch.cat([k["tokens"] for k in kept])
        self.kept = kept
        self.routed = hasattr(self.kind, "TAP")
        self.routing_missing = self.routed and any(
            k.get("routing") is None for k in kept)
        self.replay_diff = sum(k.get("replay_diff", 0) for k in kept)

    def layer(self, li: int) -> dict:
        c = self.config["config"]
        rows = [self.kind.program_cache(k["cache"][0][0], li, b, c)
                for k in self.kept for b in range(k["prompts"].shape[0])]
        return {name: torch.stack([r[name] for r in rows]).float()
                for name in rows[0]}

    def routing(self, li: int) -> dict | None:
        if not self.routed or self.routing_missing:
            return None
        layers = [k["routing"][li] for k in self.kept]
        return {name: torch.cat([r[name] for r in layers])
                for name in layers[0]}


class ReferenceOutputs:
    """The reference in fp8 put in the program's place (the control): its
    caches and routing decisions layer by layer, in step with
    the comparison."""

    def __init__(self, config: dict, weights, prompts: torch.Tensor):
        self.prompts = prompts
        self.fwd = Forward(config, weights, prompts, FP8)
        self._it = iter(self.fwd)
        self._decided = None
        self.routing_missing, self.replay_diff = False, 0

    def layer(self, li: int) -> dict:
        got, cache, self._decided, _ = next(self._it)
        assert got == li
        return cache

    def routing(self, li: int) -> dict | None:
        return self._decided

    @property
    def logits(self) -> torch.Tensor:
        for _ in self._it:
            pass
        return self.fwd.logits

    @property
    def tokens(self) -> torch.Tensor:
        return self.logits.argmax(dim=-1)


def _rel(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|p - r| / |r| over the last dim; inf where p is not finite."""
    err = (p - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    return torch.where(torch.isfinite(p).all(dim=-1), err, torch.inf)


def compare(config: dict, weights, outputs) -> dict:
    """The numbers of `outputs` (`ProgramOutputs` or `ReferenceOutputs`)
    against the float32 reference on the same prompts."""
    prompts = outputs.prompts
    cache_err, cache_max, route_gap = 0.0, 0.0, 0.0
    with full_fp32(), torch.inference_mode():
        ref = Forward(config, weights, prompts, FP32, follow=outputs.routing)
        it = iter(ref)
        for li in range(config["layers"]):
            pc = outputs.layer(li)          # first: the control routes here
            _, rc, _, gap = next(it)
            route_gap = max(route_gap, gap)
            for name, r in rc.items():
                err = _rel(pc[name].float(), r)                # (N, S)
                cache_err = max(cache_err,
                                err.median(dim=1).values.max().item())
                cache_max = max(cache_max, err.max().item())
            del pc, rc
        for _ in it:
            pass
        lr, lp = ref.logits, outputs.logits.float()
        logit = _rel(lp, lr).tolist()
        best = lr.max(dim=-1).values
        served = lr.gather(1, outputs.tokens.long().view(-1, 1))[:, 0]
        gap = ((best - served) / lr.std(dim=-1)).tolist()
    if outputs.routing_missing:
        route_gap = float("inf")
    return {"cache_err": cache_err, "cache_err_max": cache_max,
            "logit_err": max(logit) if logit else float("inf"),
            "token_gap": max(gap) if gap else float("inf"),
            "route_gap": route_gap,
            "replay_diff": outputs.replay_diff,
            "prompts": int(prompts.shape[0]),
            "logit_err_each": logit, "token_gap_each": gap}


def control(config: dict, weights, prompts: torch.Tensor) -> dict:
    """The control's numbers: the reference in fp8 in the program's place,
    judged by the same comparison."""
    with full_fp32(), torch.inference_mode():
        return compare(config, weights,
                       ReferenceOutputs(config, weights, prompts))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers the cell's
    limits name: correct if each is at or under its limit."""
    shown = {name: {"value": numbers[name], "limit": lim["limit"]}
             for name, lim in limits["numbers"].items()}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok and numbers["prompts"] > 0, shown
