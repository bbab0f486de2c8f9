"""The plain reference: a decoder's prefill in float32 PyTorch.

Embedding, one block per layer (the block kind's own file in this folder:
`mla.py`, `attn_moe.py`), the final RMSNorm and the LM head at each
prompt's last position. It runs on the weights in their published layout
(`portbench.inputs.Weights`), one layer at a time, so that only one layer's
weights are in float32 at once, and yields each layer's cache as it goes.
It uses no kernel, no cache and nothing of the program.
"""
from __future__ import annotations

import importlib
from collections.abc import Iterator

import torch

from .precision import Precision


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim (half-split rotation), positions
    0 .. S - 1 along dim -2."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


#: Query rows a tile of `causal_attention`; fixed, so that its numbers do
#: not depend on the memory free.
TILE = 1024


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, prec: Precision) -> torch.Tensor:
    """q (H, S, dk), k (Hk, S, dk), v (Hk, S, dv), H a multiple of Hk
    (query head h reads key head h // (H / Hk)) -> (H, S, dv).

    The query rows go in tiles of `TILE`, each against the keys up to its
    last position, so that no (S, S) tensor is built: one tile's scores
    are (H, TILE, S). The operands are rounded (`prec.op`) whole, before
    tiling, so that a per-tensor scale is the whole tensor's."""
    g = q.shape[0] // k.shape[0]
    q = prec.op(q)
    k = prec.op(k).repeat_interleave(g, dim=0)
    v = prec.op(v).repeat_interleave(g, dim=0)
    n = q.shape[1]
    out = q.new_empty(q.shape[0], n, v.shape[-1])
    pos = torch.arange(n, device=q.device)
    for a in range(0, n, TILE):
        b = min(a + TILE, n)
        s = torch.matmul(q[:, a:b], k[:, :b].transpose(1, 2)).mul_(scale)
        s.masked_fill_(pos[None, :b] > pos[a:b, None], float("-inf"))
        out[:, a:b] = torch.matmul(torch.softmax(s, dim=-1), v[:, :b])
        del s
    return out


def mm(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    return torch.matmul(prec.op(x), prec.op(w))


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, prec: Precision) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, gate, prec)) * mm(x, up, prec),
              down, prec)


class Forward:
    """A prefill of `tokens` (N, S) through the model of configuration
    `config` (a configuration file's contents) with weights `weights`.
    Iterating yields (layer, cache, routing decisions, gap) for each layer,
    the cache a dict of (N, S, features) float32 tensors named as the
    block kind names them; afterwards `logits` holds the last position's
    logits, (N, vocab). `follow(layer)`, if given, is called as each layer
    starts and gives the routing decisions the layer is to follow (see
    `attn_moe.route`)."""

    def __init__(self, config: dict, weights, tokens: torch.Tensor,
                 prec: Precision, follow=None):
        self.config, self.weights, self.tokens = config, weights, tokens
        self.prec, self.follow = prec, follow
        self.block = importlib.import_module(
            f"{__package__}.{config['block_kind']}")
        self.logits: torch.Tensor | None = None

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        c, w, prec = self.config["config"], self.weights, self.prec
        eps = c["rms_norm_eps"]
        x = w.top["embed"][self.tokens].float()
        for li in range(self.config["layers"]):
            follow = self.follow(li) if self.follow else None
            x, cache, decided, gap = self.block.layer(x, w.layer(li), c,
                                                      prec, follow)
            yield li, cache, decided, gap
        h = rms_norm(x[:, -1], w.top["final_norm"], eps)
        self.logits = mm(h, w.top["unembed"], prec)
