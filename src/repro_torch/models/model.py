"""Model assembly of the port (port of `repro.models.model`), for the
`attn`, `local_attn` and `rg` block kinds.

`Transformer` is an `nn.Module` holding one `Block` per block of each
layer: a segment is `count` layers of one superblock of block kinds (one
`attn` for llama; `rg, rg, local_attn` for recurrentgemma). The reference
keeps each segment's layers stacked along a leading `count` axis and scans
over them; the port keeps a `ModuleList` and loops, and `params_to_tree` /
`params_from_jax` convert between the two layouts, so a parameter tree
(and so a checkpoint) has the same bytes in both packages. Caches keep the
reference's nested layout, one dict per block of the superblock, each leaf
stacked over the segment's layers: `{"k", "v"}` (count, B, Hkv, S, hd) for
attention (S = min(window, S_max) for `local_attn`), `{"state"}`
(count, B, dr) fp32 and `{"conv"}` (count, B, 3, dr) for `rg`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

from . import layers as L
from .config import ModelConfig, _rg_width

_PORTED_KINDS = ("attn", "local_attn", "rg")


def _check_kinds(cfg: ModelConfig) -> None:
    for seg in cfg.segments:
        for kind in seg.blocks:
            if kind not in _PORTED_KINDS:
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} of superblock "
                    f"{seg.blocks} is not ported yet; the port runs "
                    f"{_PORTED_KINDS} (ROADMAP A9)")


def _norm_scale(cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((cfg.d_model,), dtype=torch.bfloat16,
                                   device=device), requires_grad=False)


class Block(nn.Module):
    """One pre-norm residual block of kind `attn` or `local_attn`
    (attention, windowed for `local_attn`, then SwiGLU) or `rg` (the
    recurrent block, then SwiGLU): the reference's `_block_apply`."""

    def __init__(self, kind: str, cfg: ModelConfig,
                 gen: torch.Generator | None, device: torch.device):
        super().__init__()
        self.kind = kind
        self.norm1 = _norm_scale(cfg, device)
        if kind == "rg":
            self.rg = L.RG(cfg, gen, device)
        else:
            self.attn = L.Attention(cfg, gen, device)
        self.norm2 = _norm_scale(cfg, device)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, gen, device)

    def forward(self, x, cfg: ModelConfig, mode: str, cache, pos):
        h = L.rms_norm(x, self.norm1, cfg.rms_eps)
        if self.kind == "rg":
            h, new_cache = L.rg_block(self.rg, h, mode, cache)
        else:
            window = cfg.window if self.kind == "local_attn" else 0
            h, new_cache = L.attention_block(self.attn, h, cfg, mode, cache,
                                             pos, window=window)
        x = x + h
        x = x + self.mlp(L.rms_norm(x, self.norm2, cfg.rms_eps))
        return x, new_cache


class Transformer(nn.Module):
    """Token embedding, `cfg.num_layers` blocks, final norm, (tied)
    unembedding. Weights only: the port serves, it does not train yet."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        _check_kinds(cfg)
        if not cfg.embed_inputs:
            raise NotImplementedError(
                f"{cfg.name}: embedding-free inputs are not ported yet "
                f"(ROADMAP A9)")
        device = torch.device(device)
        if device.type != "meta":           # meta: shapes only, no data
            device = resolve_device(device)
        if gen is not None and gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(kind, cfg, gen, device)
            for seg in cfg.segments for _ in range(seg.count)
            for kind in seg.blocks)
        self.final_norm = _norm_scale(cfg, device)
        shape = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.Parameter(
            L._normal(gen, shape, cfg.d_model ** -0.5) if gen is not None
            else torch.empty(shape, dtype=torch.bfloat16, device=device),
            requires_grad=False)
        if not cfg.tie_embeddings:
            shape = (cfg.d_model, cfg.vocab_size)
            self.unembed = nn.Parameter(
                L._normal(gen, shape, cfg.d_model ** -0.5) if gen is not None
                else torch.empty(shape, dtype=torch.bfloat16, device=device),
                requires_grad=False)

    def layers_of(self):
        """(segment index, layer index within it, block index within the
        superblock, block) in order."""
        i = 0
        for si, seg in enumerate(self.cfg.segments):
            for li in range(seg.count):
                for bi in range(len(seg.blocks)):
                    yield si, li, bi, self.blocks[i]
                    i += 1

    @torch.inference_mode()
    def forward(self, inputs: torch.Tensor, *, mode: str = "train",
                cache=None, pos: int | None = None):
        """inputs: (B, S) token ids. Returns (logits, new_cache, aux)."""
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r}")
        if mode == "decode" and (cache is None or pos is None):
            raise ValueError("decode needs a cache and a position")
        x = self.embed[inputs.long()]
        # per segment, per block of the superblock: each layer's new cache
        per_layer: list[list[list[dict]]] = [
            [[] for _ in seg.blocks] for seg in cfg.segments]
        for si, li, bi, block in self.layers_of():
            lc = None
            if cache is not None:
                lc = {name: t[li] for name, t in cache[si][bi].items()}
            x, nc = block(x, cfg, mode, lc, pos)
            per_layer[si][bi].append(nc)
        x = L.rms_norm(x, self.final_norm, cfg.rms_eps)
        if cfg.tie_embeddings:
            logits = x @ self.embed.t()
        else:
            logits = x @ self.unembed
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train":
            return logits, None, aux
        if mode == "decode":             # written in place: same tensors
            return logits, cache, aux
        new_cache = tuple(
            tuple({name: torch.stack([c[name] for c in layers])
                   for name in layers[0]} for layers in seg)
            for seg in per_layer)
        return logits, new_cache, aux


def forward(model: Transformer, inputs: torch.Tensor, *,
            mode: str = "train", cache=None, pos: int | None = None):
    """inputs: (B, S) token ids. Returns (logits, new_cache, aux_loss)."""
    return model(inputs, mode=mode, cache=cache, pos=pos)


# ---------------------------------------------------------------------------
# Init and caches
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> Transformer:
    """A model with random weights drawn from `generator` (on `device`; a
    fresh generator seeded 0 when None). Same distributions as the
    reference's `init_params`; the numbers differ, since the two packages'
    generators differ: to carry the reference's weights across, use
    `params_from_jax`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return Transformer(cfg, generator, device)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of `init_params(cfg)` as meta tensors: shapes
    and dtypes without allocating (a full-width model on any host)."""
    return params_to_tree(Transformer(cfg, None, "meta"))


def _block_cache_spec(kind: str, cfg: ModelConfig, B: int,
                      S_max: int) -> dict:
    """{name: (shape, dtype)} of one block's cache (the reference's
    `_block_cache_spec`)."""
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads_padded
    if kind == "rg":
        dr = _rg_width(cfg.d_model)
        return {"state": ((B, dr), torch.float32),
                "conv": ((B, 3, dr), torch.bfloat16)}
    s = S_max
    if kind == "local_attn" and cfg.window:
        s = min(cfg.window, S_max)
    return {"k": ((B, hkv, s, hd), torch.bfloat16),
            "v": ((B, hkv, s, hd), torch.bfloat16)}


def init_cache(cfg: ModelConfig, B: int, S_max: int, *,
               device: str | torch.device = "cuda"):
    """Zeroed cache in the nested segment layout."""
    _check_kinds(cfg)
    device = resolve_device(device)
    return tuple(
        tuple({name: torch.zeros((seg.count, *shape), dtype=dtype,
                                 device=device)
               for name, (shape, dtype) in _block_cache_spec(
                   kind, cfg, B, S_max).items()} for kind in seg.blocks)
        for seg in cfg.segments)


def pad_cache_to(cache, cfg: ModelConfig, S_max: int):
    """Right-pad a prefill cache's sequence axis to S_max so decode can
    write into it: the 5-D `k` / `v` leaves of full attention. Window
    caches (at most `cfg.window` long) and recurrent states are fixed-size
    and stay as they are, as in the reference."""
    def pad(name: str, leaf: torch.Tensor) -> torch.Tensor:
        if name not in ("k", "v") or leaf.dim() != 5:
            return leaf
        s = leaf.shape[3]
        if cfg.window and s <= cfg.window:
            return leaf
        if s < S_max:
            return torch.nn.functional.pad(leaf, (0, 0, 0, S_max - s))
        return leaf
    return tuple(tuple({name: pad(name, t) for name, t in block.items()}
                       for block in seg) for seg in cache)


# ---------------------------------------------------------------------------
# The reference's parameter tree
# ---------------------------------------------------------------------------

_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_RG = ("w_x", "w_gate", "conv_w", "conv_b", "w_rg", "w_ig", "lam", "w_out")
_MLP = ("w_gate", "w_up", "w_down")


def _block_names(cfg: ModelConfig, kind: str):
    """(tree path within a block, module attribute path) of every leaf of
    a block of `kind`."""
    if kind == "rg":
        mixer = [(("rg", n), ("rg", n)) for n in _RG]
    else:
        attn = _ATTN + (_BIAS if cfg.qkv_bias else ())
        mixer = [(("attn", n), ("attn", n)) for n in attn]
    return (mixer + [(("mlp", n), ("mlp", n)) for n in _MLP]
            + [(("norm1",), ("norm1",)), (("norm2",), ("norm2",))])


def params_to_tree(model: Transformer) -> dict:
    """The reference's layout: `{"segments": ((block,),) per segment,
    "final_norm", "embed"[, "unembed"]}` with each block leaf stacked over
    the segment's layers. Tensors stay on the model's device."""
    cfg = model.cfg
    segments = []
    for si, seg in enumerate(cfg.segments):
        trees = []
        for bi, kind in enumerate(seg.blocks):
            blocks = [b for s, _, i, b in model.layers_of()
                      if (s, i) == (si, bi)]
            tree: dict[str, Any] = {}
            for path, attr in _block_names(cfg, kind):
                leaf = torch.stack([_get(b, attr) for b in blocks])
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = leaf
            trees.append(tree)
        segments.append(tuple(trees))
    out = {"segments": tuple(segments), "final_norm": model.final_norm.data,
           "embed": model.embed.data}
    if not cfg.tie_embeddings:
        out["unembed"] = model.unembed.data
    return out


def _get(module: nn.Module, attr: tuple[str, ...]) -> torch.Tensor:
    obj: Any = module
    for a in attr:
        obj = getattr(obj, a)
    return obj.data


def _as_tensor(leaf) -> torch.Tensor:
    """A tree leaf as a CPU or device tensor: numpy uint16 leaves are bf16
    bit patterns (numpy's bf16 does not go through `torch.from_numpy`)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.ascontiguousarray(leaf)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda") -> Transformer:
    """A model holding the weights of a parameter tree in the reference's
    layout (`repro.models.init_params`, or a restored checkpoint). Leaves
    may be numpy arrays (bf16 given as fp32 values or uint16 bit views)
    or tensors; each is cast to the parameter's dtype (bf16, or fp32 for
    the rg blocks' `lam`)."""
    model = Transformer(cfg, None, device)
    blocks = {(si, li, bi): b for si, li, bi, b in model.layers_of()}
    for si, seg in enumerate(cfg.segments):
        for bi, kind in enumerate(seg.blocks):
            node = tree["segments"][si][bi]
            for path, attr in _block_names(cfg, kind):
                leaf = node
                for key in path:
                    leaf = leaf[key]
                stacked = _as_tensor(leaf)
                for li in range(seg.count):
                    dst = _get(blocks[(si, li, bi)], attr)
                    _copy(dst, stacked[li], path)
    _copy(model.final_norm.data, _as_tensor(tree["final_norm"]),
          ("final_norm",))
    _copy(model.embed.data, _as_tensor(tree["embed"]), ("embed",))
    if not cfg.tie_embeddings:
        _copy(model.unembed.data, _as_tensor(tree["unembed"]), ("unembed",))
    return model


def _copy(dst: torch.Tensor, src: torch.Tensor, path) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)}, "
                         f"model wants {tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))
