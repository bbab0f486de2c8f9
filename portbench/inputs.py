"""Inputs made from the seed: the weights and each batch's prompts.

Both sides get the same inputs, and both are made on the device the run
measures, from a `torch.Generator` there. The weights come in their
published layout, in the dtype they are served in: all the leaves of one
dtype are views of one flat buffer, drawn from N(0, 1) in a few large
calls and then scaled leaf by leaf (norm scales drawn as 1 + 0.1 N(0, 1)).
A leaf's scale is its block kind's default (1 / sqrt(fan-in) for a
matrix) times the configuration's `draw_scale` of that leaf's name, if it
names one.
The same seed gives the same bytes, so the reference can draw the weights
again once the program has been freed.
"""
from __future__ import annotations

import hashlib
import importlib
import random

import torch

CHUNK = 1 << 28             # elements a draw; fixed, so the bytes are too


def sub_seed(seed: int, what: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def block_module(kind: str):
    return importlib.import_module(f"portbench.blocks.{kind}")


def top_leaves(c: dict) -> list[tuple[str, tuple, torch.dtype, float | None]]:
    d, v = c["hidden_size"], c["vocab_size"]
    return [("embed", (v, d), torch.bfloat16, d ** -0.5),
            ("final_norm", (d,), torch.bfloat16, None),
            ("unembed", (d, v), torch.bfloat16, d ** -0.5)]


class Weights:
    """`layer(i)`: layer i's leaves by name; `top`: the embedding, the
    final norm and the head."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        c = config["config"]
        per_layer = block_module(config["block_kind"]).leaves(c)
        scale = config.get("draw_scale", {})

        def std_of(name: str, std: float | None) -> float | None:
            return None if std is None else std * scale.get(name, 1.0)
        plan = [((None, name), shape, dtype, std_of(name, std))
                for name, shape, dtype, std in top_leaves(c)]
        plan += [((li, name), shape, dtype, std_of(name, std))
                 for li in range(config["layers"])
                 for name, shape, dtype, std in per_layer]
        gen = torch.Generator(device=device)
        gen.manual_seed(sub_seed(seed, "weights"))
        views: dict = {}
        for dtype in sorted({p[2] for p in plan}, key=str):
            leaves = [p for p in plan if p[2] == dtype]
            total = sum(_numel(p[1]) for p in leaves)
            flat = torch.empty(total, dtype=dtype, device=device)
            for i in range(0, total, CHUNK):
                flat[i:i + CHUNK].normal_(generator=gen)
            off = 0
            for key, shape, _, std in leaves:
                n = _numel(shape)
                view = flat[off:off + n].view(shape)
                if std is None:
                    view.mul_(0.1).add_(1.0)
                else:
                    view.mul_(std)
                views[key] = view
                off += n
        self.top = {name: views[(None, name)] for name, *_ in top_leaves(c)}
        self._layers = [{name: views[(li, name)] for name, *_ in per_layer}
                        for li in range(config["layers"])]

    def layer(self, i: int) -> dict:
        return self._layers[i]


def _numel(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class Prompts:
    """Batch after batch of `batch` prompts of `length` token ids, uniform
    over the vocabulary, drawn on the device from the seed."""

    def __init__(self, seed: int, what: str, vocab: int, batch: int,
                 length: int, device: torch.device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(sub_seed(seed, what))
        self.shape, self.vocab, self.device = (batch, length), vocab, device

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)


class Sample:
    """A uniform sample of `k` of the batches offered, drawn from the seed
    as they come (reservoir sampling): only the kept batches' outputs stay
    alive. `offer(keep, *args)` calls `keep(*args)` for the item only if
    it is kept."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(sub_seed(seed, "sample"))
        self.k, self.seen = k, 0
        self.kept: list[tuple[int, object]] = []

    def offer(self, keep, *args) -> None:
        i = self.seen
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, keep(*args)))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, keep(*args))

    def items(self) -> list:
        return [item for _, item in sorted(self.kept, key=lambda t: t[0])]
