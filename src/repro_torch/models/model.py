"""Model assembly of the port (port of `repro.models.model`), for every
block kind: `attn`, `local_attn`, `mla`, `attn_moe`, `rg`, `rwkv` and
`cross_attn`, and the port's own `mla_moe` (MLA and a MoE FFN:
kimi-k2-instruct).

`Transformer` is an `nn.Module` holding one `Block` per block of each
layer: a segment is `count` layers of one superblock of block kinds (one
`attn` for llama and hubert, one `mla` for minicpm3, one `attn_moe` for
phi3.5-moe and kimi-k2, one `rwkv` for rwkv6; `rg, rg, local_attn` for
recurrentgemma; four `attn` and a `cross_attn` for llama-3.2-vision). The
reference keeps each segment's layers stacked along a leading `count` axis
and scans over them; the port keeps a `ModuleList` and loops, and
`params_to_tree` / `params_from_jax` convert between the two layouts, so
a parameter tree
(and so a checkpoint) has the same bytes in both packages. Caches keep the
reference's nested layout, one dict per block of the superblock, each leaf
stacked over the segment's layers: `{"k", "v"}` (count, B, Hkv, S, hd) for
attention and `attn_moe` (S = min(window, S_max) for `local_attn`),
`{"ckv"}` (count, B, S, kv_lora) and `{"kr"}` (count, B, S, rope) for
`mla` and `mla_moe`, `{"state"}` (count, B, dr) fp32 and `{"conv"}`
(count, B, 3, dr) for `rg`, `{"state"}` (count, B, H, hd, hd) fp32, `{"shift", "shift_c"}`
(count, B, D) for `rwkv`, and the vision keys and values `{"k", "v"}`
(count, B, Hkv, vision_seq, hd) for `cross_attn`, which never grow.
`forward`'s aux is the sum of the MoE blocks' load-balance losses
(0 without one), as the reference's scan sums them. A config with
`embed_inputs=False` (hubert's stub front end) has no `embed`: its inputs
are (B, S, D) embeddings.
"""
from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.device import resolve_device

from . import layers as L
from . import partitioning as PT
from .config import ModelConfig, RoutedMoEConfig, _rg_width


def _norm_scale(cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((cfg.d_model,), dtype=torch.bfloat16,
                                   device=device), requires_grad=False)


class Block(nn.Module):
    """One pre-norm residual block, the reference's `_block_apply`: a
    mixer, then a feed-forward. The mixer is attention for `attn`,
    `local_attn` (windowed) and `attn_moe`, MLA for `mla` and `mla_moe`,
    the recurrent block for `rg`, the RWKV6 time-mix for `rwkv` and gated
    cross-attention for `cross_attn`; the feed-forward is the MoE FFN for
    `attn_moe` and `mla_moe`, the RWKV channel-mix for `rwkv`, and SwiGLU
    for every other kind (scaled by tanh(gate_ffn) for `cross_attn`).
    `mla_moe` has no device-mesh path (`moe_ffn` raises)."""

    def __init__(self, kind: str, cfg: ModelConfig,
                 gen: torch.Generator | None, device: torch.device):
        super().__init__()
        self.kind = kind
        self.norm1 = _norm_scale(cfg, device)
        if kind == "rg":
            self.rg = L.RG(cfg, gen, device)
        elif kind in ("mla", "mla_moe"):
            self.mla = L.MLA(cfg, gen, device)
        elif kind == "rwkv":
            self.rwkv = L.RWKV(cfg, gen, device)
        elif kind == "cross_attn":
            self.xattn = L.CrossAttention(cfg, gen, device)
        else:
            self.attn = L.Attention(cfg, gen, device)
        self.norm2 = _norm_scale(cfg, device)
        if kind in ("attn_moe", "mla_moe"):
            self.moe = L.MoE(cfg, gen, device)
        elif kind == "rwkv":
            self.cmix = L.RWKVChannel(cfg, gen, device)
        else:
            self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, gen, device)

    def forward(self, x, cfg: ModelConfig, mode: str, cache, pos,
                vision=None, mesh=None):
        """-> (x, new_cache, aux): aux is the MoE load-balance loss of an
        `attn_moe` block, and of an `mla_moe` block in train mode; None
        otherwise. `vision`
        (B, Sv, D) feeds a `cross_attn` block's keys and values in train
        and prefill mode; the other kinds ignore it."""
        # with seq_parallel the residual stream's sequence is split over
        # `model`: gathered before the mixer and the FFN (Megatron SP)
        h = L.cst(L.rms_norm(x, self.norm1, cfg.rms_eps), mesh, "B", None,
                  None)
        if self.kind == "rg":
            h, new_cache = L.rg_block(self.rg, h, mode, cache, mesh)
        elif self.kind in ("mla", "mla_moe"):
            h, new_cache = L.mla_block(self.mla, h, cfg, mode, cache, pos,
                                       mesh)
        elif self.kind == "rwkv":
            h, new_cache = L.rwkv_block(self.rwkv, h, cfg, mode, cache, mesh)
        elif self.kind == "cross_attn":
            h, new_cache = L.cross_attention_block(self.xattn, h, cfg, mode,
                                                   cache, vision, mesh)
        else:
            window = cfg.window if self.kind == "local_attn" else 0
            h, new_cache = L.attention_block(self.attn, h, cfg, mode, cache,
                                             pos, window=window, mesh=mesh)
        x = x + h
        h = L.cst(L.rms_norm(x, self.norm2, cfg.rms_eps), mesh, "B", None,
                  None)
        aux = None
        if self.kind in ("attn_moe", "mla_moe"):
            h, aux = L.moe_ffn(self.moe, h, cfg, mesh,
                               train=mode == "train")
        elif self.kind == "rwkv":
            # decode writes the channel-mix's shift into the same cache
            h, c2 = L.rwkv_channel_mix(self.cmix, h, mode, cache, mesh)
            if mode == "prefill":
                new_cache = {**new_cache, **c2}
        else:
            h = self.mlp(h, mesh)
            if self.kind == "cross_attn":
                h = torch.tanh(self.xattn.gate_ffn).to(x.dtype) * h
        return x + h, new_cache, aux


class Transformer(nn.Module):
    """Token embedding (none when `cfg.embed_inputs` is False),
    `cfg.num_layers` blocks, final norm, (tied) unembedding. Its
    parameters are frozen (`requires_grad=False`) for serving;
    `train.init_train_state` and `train.train_state_from_jax` make them
    trainable."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
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
        if cfg.embed_inputs:
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

    def forward(self, inputs: torch.Tensor, *, mode: str = "train",
                cache=None, pos: int | None = None, remat: str = "none",
                vision: torch.Tensor | None = None, mesh=None,
                seq_parallel: bool = False):
        """inputs: (B, S) token ids, or (B, S, D) embeddings (cast to bf16)
        when `cfg.embed_inputs` is False. vision: (B, vision_seq, D), the
        stub vision embeddings a `cross_attn` block attends to in train
        and prefill mode (decode reads their keys and values from the
        cache). Returns (logits, new_cache, aux).

        Prefill and decode run under `torch.inference_mode()` (under
        `torch.no_grad()` with a mesh). Train mode
        records autograd where the parameters require grad; `remat="block"`
        then checkpoints each superblock (`torch.utils.checkpoint`, the
        reference's `jax.checkpoint` of its scan body): the backward keeps
        only each superblock's input and runs the superblock again,
        attention forward included.

        mesh: a `DeviceMesh` over which the parameters are DTensors
        (`shard_model`): activations are pinned as the reference's `cst`
        pins them, and inputs that are not DTensors yet are split by
        `partitioning.input_sharding_for` (each rank passing the whole
        batch). `seq_parallel` splits the residual stream's sequence over
        `model` in train mode (Megatron SP), as the reference's does.

        Recorded as the root span `forward` (`repro_torch.obs`), the final
        norm and the unembedding as its child `head`."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r}")
        if remat not in ("none", "block"):
            raise ValueError(f"remat {remat!r}; expected 'none' or 'block'")
        if mode == "decode" and (cache is None or pos is None):
            raise ValueError("decode needs a cache and a position")
        # (DTensor views of parameters fail under inference_mode: a sharded
        # prefill or decode runs under no_grad)
        with obs.span("forward", device=inputs.device, mode=mode,
                      B=inputs.shape[0], S=inputs.shape[1]), \
                (contextlib.nullcontext() if mode == "train"
                 else torch.inference_mode() if mesh is None
                 else torch.no_grad()), replicating(mesh):
            if mesh is not None:
                inputs, vision = (None if t is None else shard_input(t, mesh)
                                  for t in (inputs, vision))
            return self._forward(inputs, mode, cache, pos,
                                 remat == "block" and mode == "train",
                                 vision, mesh,
                                 "model" if seq_parallel and mode == "train"
                                 else None)

    def _forward(self, inputs, mode, cache, pos, remat: bool, vision,
                 mesh=None, sp=None):
        cfg = self.cfg
        if cfg.embed_inputs:
            x = (self.embed[inputs.long()] if mesh is None
                 else _embed_on_shards(self.embed, inputs, mesh))
        else:           # bf16, as the reference casts; fp32 weights promote
            x = inputs.to(torch.bfloat16)
        x = L.cst(x, mesh, "B", sp, None)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        # per segment, per block of the superblock: each layer's new cache
        per_layer: list[list[list[dict]]] = [
            [[] for _ in seg.blocks] for seg in cfg.segments]
        i = 0
        for si, seg in enumerate(cfg.segments):
            for li in range(seg.count):
                blocks = self.blocks[i:i + len(seg.blocks)]
                i += len(seg.blocks)
                if remat:
                    # no randomness in a block: no RNG state to replay
                    x, aux_l = checkpoint(_superblock, x, blocks, cfg,
                                          vision, mesh, sp,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
                    if aux_l is not None:
                        aux_total = aux_total + aux_l
                    continue
                for bi, block in enumerate(blocks):
                    lc = None
                    if cache is not None:
                        lc = {name: t[li]
                              for name, t in cache[si][bi].items()}
                    x, nc, aux_b = block(x, cfg, mode, lc, pos, vision, mesh)
                    x = L.cst(x, mesh, "B", sp, None)
                    if aux_b is not None:
                        aux_total = aux_total + aux_b
                    per_layer[si][bi].append(nc)
        with obs.span("head"):
            x = L.cst(L.rms_norm(x, self.final_norm, cfg.rms_eps), mesh, "B",
                      None, None)
            if cfg.tie_embeddings:
                logits = x @ self.embed.t()
            else:
                logits = x @ self.unembed
            logits = L.cst(logits, mesh, "B", None, "model")
        if mode == "train":
            return logits, None, aux_total
        if mode == "decode":             # written in place: same tensors
            return logits, cache, aux_total
        new_cache = tuple(
            tuple({name: torch.stack([c[name] for c in layers])
                   for name in layers[0]} for layers in seg)
            for seg in per_layer)
        return logits, new_cache, aux_total


def _superblock(x, blocks, cfg: ModelConfig, vision, mesh=None, sp=None):
    """One superblock in train mode: its blocks in order. Returns x and
    the sum of its blocks' aux losses (None without a MoE block)."""
    aux = None
    for block in blocks:
        x, _, aux_b = block(x, cfg, "train", None, None, vision, mesh)
        x = L.cst(x, mesh, "B", sp, None)
        if aux_b is not None:
            aux = aux_b if aux is None else aux + aux_b
    return x, aux


def forward(model: Transformer, inputs: torch.Tensor, *,
            mode: str = "train", cache=None, pos: int | None = None,
            remat: str = "none", vision: torch.Tensor | None = None,
            mesh=None, seq_parallel: bool = False):
    """inputs: (B, S) token ids, or (B, S, D) embeddings without an
    embedding table; vision: (B, vision_seq, D) for a `cross_attn` model.
    mesh: the `DeviceMesh` of a model placed by `shard_model`.
    Returns (logits, new_cache, aux_loss)."""
    return model(inputs, mode=mode, cache=cache, pos=pos, remat=remat,
                 vision=vision, mesh=mesh, seq_parallel=seq_parallel)


# ---------------------------------------------------------------------------
# On a device mesh
# ---------------------------------------------------------------------------

def replicating(mesh):
    """Inside a sharded forward, plain tensors (positions, masks, the rope
    table) mix with DTensors as replicated ones."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def shard_input(t: torch.Tensor, mesh):
    """An input as a DTensor: as it is, or, whole on every rank, split by
    `input_sharding_for` (batch over the batch axes where it divides)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t
    return PT.distribute(t, PT.input_sharding_for(mesh, tuple(t.shape)))


def _embed_on_shards(embed, tokens, mesh):
    """The embedding gather on each device's shards: the table whole over
    the batch axes (all-gathered over `data`, its gradient a partial sum
    there) and split by rows over `model` as it is placed, each device
    gathering the rows it holds (zeros for the others), summed over
    `model` by the `cst` that follows."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    vocab = ("model" in names
             and embed.placements[names.index("model")] == Shard(0))
    r, n = L._axis(mesh, "model")
    epl = tuple(Shard(0) if name == "model" and vocab else Replicate()
                for name in mesh.mesh_dim_names)
    tpl = tuple(tokens.placements)
    opl = L._partial_on(tpl, mesh, ("model",) if vocab and n > 1 else ())

    def gather(table, ids):
        ids = ids.long()
        if opl == tpl:                       # the rows are all here
            return table[ids]
        rows = table.shape[0]
        local = ids - r * rows
        mine = (local >= 0) & (local < rows)
        return torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                           0.0).to(table.dtype)
    return L._on_shards(gather, mesh, (embed, tokens), (epl, tpl), opl,
                        (L._partial_on(epl, mesh, PT.batch_axes(mesh)), tpl))


def param_paths(model: Transformer):
    """(parameter, its leaf's path in the reference's tree, the leaf's
    shape, whether the leaf is stacked over layers) for every parameter."""
    cfg = model.cfg
    for si, li, bi, block in model.layers_of():
        count = cfg.segments[si].count
        for path in _block_names(cfg, block.kind):
            p = _param(block, path)
            yield (p, "/".join(("segments", str(si), str(bi)) + path),
                   (count, *p.shape), True)
    top = (["final_norm"] + (["embed"] if cfg.embed_inputs else [])
           + ([] if cfg.tie_embeddings else ["unembed"]))
    for name in top:
        p = getattr(model, name)
        yield p, name, tuple(p.shape), False


def layer_shardings(model: Transformer, mesh) -> list:
    """The `partitioning.Sharding` of each parameter of `model`, in the
    order of `model.parameters()`: its leaf's spec, the stacked layer dim
    dropped."""
    specs = {id(p): PT.spec_for_param(path, shape, mesh)[1 if stacked
                                                           else 0:]
             for p, path, shape, stacked in param_paths(model)}
    return [PT.Sharding(mesh, specs[id(p)]) for p in model.parameters()]


def shard_model(model: Transformer, mesh) -> Transformer:
    """Place every parameter of `model` as a DTensor on `mesh` by
    `param_placements`, in place (same names, same order); a parameter
    that is a DTensor already is gathered first (a re-mesh). Every rank
    must hold the same values; nothing is sent. Returns the model."""
    from torch.distributed.tensor import DTensor
    placed = {id(p): sh.placements
              for p, sh in zip(model.parameters(),
                               layer_shardings(model, mesh))}
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is None or id(p) not in placed:
                continue
            data = p.data
            if isinstance(data, DTensor):
                data = data.full_tensor()
            new = nn.Parameter(PT.distribute(data, placed[id(p)], mesh),
                               requires_grad=p.requires_grad)
            module._parameters[name] = new
    return model


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
    if kind in ("mla", "mla_moe"):
        c = cfg.mla
        return {"ckv": ((B, S_max, c.kv_lora_rank), torch.bfloat16),
                "kr": ((B, S_max, c.qk_rope_head_dim), torch.bfloat16)}
    if kind == "rwkv":
        hd_r = cfg.rwkv_head_dim
        return {"state": ((B, cfg.d_model // hd_r, hd_r, hd_r),
                          torch.float32),
                "shift": ((B, cfg.d_model), torch.bfloat16),
                "shift_c": ((B, cfg.d_model), torch.bfloat16)}
    s = S_max
    if kind == "cross_attn":
        s = cfg.vision_seq
    if kind == "local_attn" and cfg.window:
        s = min(cfg.window, S_max)
    return {"k": ((B, hkv, s, hd), torch.bfloat16),
            "v": ((B, hkv, s, hd), torch.bfloat16)}


def init_cache(cfg: ModelConfig, B: int, S_max: int, *,
               device: str | torch.device = "cuda"):
    """Zeroed cache in the nested segment layout. A `cross_attn` block's
    vision keys and values are zeros too: decode from such a cache attends
    to no image; prefill fills them."""
    device = resolve_device(device)
    return tuple(
        tuple({name: torch.zeros((seg.count, *shape), dtype=dtype,
                                 device=device)
               for name, (shape, dtype) in _block_cache_spec(
                   kind, cfg, B, S_max).items()} for kind in seg.blocks)
        for seg in cfg.segments)


def pad_cache_to(cache, cfg: ModelConfig, S_max: int):
    """Right-pad a prefill cache's sequence axis to S_max so decode can
    write into it, by block kind: the `k` / `v` leaves of `attn` and
    `attn_moe` (and of `local_attn` without a window; axis 3) and the
    `ckv` / `kr` latent leaves of `mla` and `mla_moe` (axis 2). Window
    caches (the window long), recurrent states (`rg`, `rwkv`) and a `cross_attn`
    block's vision keys and values are fixed-size and stay as they are.
    (The reference pads by leaf name, vision keys included: decode then
    attends to zero keys, each unmasked at score 0, which dilutes its
    softmax; ROADMAP C3.)"""
    def pad(leaf: torch.Tensor, axis: int) -> torch.Tensor:
        s = leaf.shape[axis]
        if s >= S_max:
            return leaf
        widths = (0, 0) * (leaf.dim() - 1 - axis) + (0, S_max - s)
        if hasattr(leaf, "to_local"):   # a DTensor: its sequence is whole
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(
                torch.nn.functional.pad(leaf.to_local(), widths),
                leaf.device_mesh, leaf.placements, run_check=False)
        return torch.nn.functional.pad(leaf, widths)

    def axis_of(kind: str) -> int | None:
        if kind in ("attn", "attn_moe") or (kind == "local_attn"
                                            and not cfg.window):
            return 3
        return 2 if kind in ("mla", "mla_moe") else None
    out = []
    for seg, seg_cache in zip(cfg.segments, cache, strict=True):
        blocks = []
        for kind, block in zip(seg.blocks, seg_cache, strict=True):
            axis = axis_of(kind)
            blocks.append(block if axis is None else
                          {name: pad(t, axis) for name, t in block.items()})
        out.append(tuple(blocks))
    return tuple(out)


# ---------------------------------------------------------------------------
# The reference's parameter tree
# ---------------------------------------------------------------------------

_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_RG = ("w_x", "w_gate", "conv_w", "conv_b", "w_rg", "w_ig", "lam", "w_out")
_MLP = ("w_gate", "w_up", "w_down")
_MLA = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo")
_MOE = ("router", "w_gate", "w_up", "w_down")
_RWKV = ("mu", "w_r", "w_k", "w_v", "w_g", "w_o", "w_decay", "decay_base",
         "bonus", "ln_x")
_CMIX = ("mu_c", "w_kc", "w_vc")
_GATES = ("gate_attn", "gate_ffn")


def _block_names(cfg: ModelConfig, kind: str) -> list[tuple[str, ...]]:
    """The path of every leaf of a block of `kind`: its keys in the
    block's tree, which are also its module attributes."""
    attn = _ATTN + (_BIAS if cfg.qkv_bias else ())
    if kind == "rg":
        mixer = [("rg", n) for n in _RG]
    elif kind in ("mla", "mla_moe"):
        mixer = [("mla", n) for n in _MLA]
    elif kind == "rwkv":
        mixer = [("rwkv", n) for n in _RWKV]
    elif kind == "cross_attn":
        mixer = [("xattn", n) for n in attn + _GATES]
    else:
        mixer = [("attn", n) for n in attn]
    if kind in ("attn_moe", "mla_moe"):
        ffn = [("moe", n) for n in _MOE]
        if isinstance(cfg.moe, RoutedMoEConfig):
            ffn.append(("moe", "correction_bias"))
        if cfg.moe.num_shared_experts:
            ffn += [("moe", "shared", n) for n in _MLP]
    elif kind == "rwkv":
        ffn = [("cmix", n) for n in _CMIX]
    else:
        ffn = [("mlp", n) for n in _MLP]
    return mixer + ffn + [("norm1",), ("norm2",)]


def params_to_tree(model: Transformer) -> dict:
    """The reference's layout: `{"segments": ((block,),) per segment,
    "final_norm"[, "embed"][, "unembed"]}` with each block leaf stacked over
    the segment's layers. Tensors stay on the model's device."""
    return tree_of(model, lambda p: p.data)


def tree_of(model: Transformer, value) -> dict:
    """A tree in the reference's parameter layout whose leaf for each
    parameter `p` of `model` is `value(p)` (a tensor of p's shape),
    stacked over each segment's layers."""
    cfg = model.cfg
    segments = []
    for si, seg in enumerate(cfg.segments):
        trees = []
        for bi, kind in enumerate(seg.blocks):
            blocks = [b for s, _, i, b in model.layers_of()
                      if (s, i) == (si, bi)]
            tree: dict[str, Any] = {}
            for path in _block_names(cfg, kind):
                leaf = torch.stack([value(_param(b, path)) for b in blocks])
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = leaf
            trees.append(tree)
        segments.append(tuple(trees))
    out = {"segments": tuple(segments), "final_norm": value(model.final_norm)}
    if cfg.embed_inputs:
        out["embed"] = value(model.embed)
    if not cfg.tie_embeddings:
        out["unembed"] = value(model.unembed)
    return out


def _param(module: nn.Module, attr: tuple[str, ...]) -> nn.Parameter:
    obj: Any = module
    for a in attr:
        obj = getattr(obj, a)
    return obj


def param_leaves(model: Transformer, tree: dict):
    """(parameter, its tensor in `tree`, tree path) for every parameter of
    `model`, `tree` in the reference's layout (`tree_of`): a block leaf's
    tensor is its layer's slice of the stacked leaf. numpy leaves become
    CPU tensors (uint16 ones as bf16 bit patterns)."""
    cfg = model.cfg
    blocks = {(si, li, bi): b for si, li, bi, b in model.layers_of()}
    for si, seg in enumerate(cfg.segments):
        for bi, kind in enumerate(seg.blocks):
            node = tree["segments"][si][bi]
            for path in _block_names(cfg, kind):
                leaf = node
                for key in path:
                    leaf = leaf[key]
                stacked = _as_tensor(leaf)
                for li in range(seg.count):
                    yield (_param(blocks[(si, li, bi)], path), stacked[li],
                           path)
    top = (["final_norm"] + (["embed"] if cfg.embed_inputs else [])
           + ([] if cfg.tie_embeddings else ["unembed"]))
    for name in top:
        yield getattr(model, name), _as_tensor(tree[name]), (name,)


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
    the rg blocks' `lam`, the routers and their correction biases,
    rwkv's `decay_base` and `bonus` and the cross-attention gates)."""
    model = Transformer(cfg, None, device)
    for param, leaf, path in param_leaves(model, tree):
        _copy(param.data, leaf, path)
    return model


def _copy(dst: torch.Tensor, src: torch.Tensor, path) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)}, "
                         f"model wants {tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))
