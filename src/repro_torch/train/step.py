"""Serving step functions (port of `repro.train.step`'s
`make_serve_prefill` / `make_serve_decode`):

  serve_prefill(model, tokens)            -> (logits_last, cache)
  serve_decode(model, token, cache, pos)  -> (logits, cache)
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward


def make_serve_prefill(cfg: ModelConfig):
    """serve_prefill(model, tokens) -> (last-position logits, cache). The
    cache's sequence capacity equals the prompt length; the server pads it
    to S_max before decode."""
    def serve_prefill(model, tokens):
        logits, cache, _ = forward(model, tokens, mode="prefill")
        return logits[:, -1], cache
    return serve_prefill


def make_serve_decode(cfg: ModelConfig):
    """serve_decode(model, token, cache, pos) -> (logits, cache): one new
    token per sequence against a cache filled to `pos`."""
    def serve_decode(model, token, cache, pos: int):
        logits, new_cache, _ = forward(model, token, mode="decode",
                                       cache=cache, pos=pos)
        return logits[:, 0], new_cache
    return serve_decode
