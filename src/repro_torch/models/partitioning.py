"""Parameter / cache / input partitioning of the port (port of
`repro.models.partitioning`): path-pattern rules -> specs -> DTensor
placements.

Megatron-style tensor parallelism on the `model` axis (column-parallel
in-projections, row-parallel out-projections, expert-parallel MoE), FSDP
on the `data` axis for the other large dim. Multi-pod meshes add a `pod`
axis used only for batch parallelism (parameters replicated across pods;
the gradient reduction spans pod + data).

A spec is the reference's PartitionSpec as a tuple, one entry per tensor
dim: a mesh axis name, a tuple of names, or None. The rules are matched
to the same paths (`"segments/0/1/attn/wq"`: segment / block of the
superblock / module / parameter) that `models.model.params_to_tree`
gives, in the same first-match order, on the same stacked shapes (a
segment's leaves carry a leading layer dim, replicated), so the port's
specs equal the reference's leaf by leaf. Every rule is guarded by
divisibility: a mesh axis is dropped from a dim it does not divide.

`Sharding` is NamedSharding's counterpart: a spec over a mesh, and the
DTensor placements it gives, one per mesh dim (`Shard(d)` where tensor dim
d is split over that mesh dim, else `Replicate()`). A dim split over two
axes, ("pod", "data"), is `Shard(d)` on both, split over the first axis
and then within it over the second: the rows the reference's
NamedSharding gives each device (pinned by tests/test_torch_mesh.py). The
port's modules hold one parameter per layer, so placing a layer's
parameter drops the stacked leading dim (`layer_placements`).

A mesh is anything with `mesh_dim_names` and `shape` (a `DeviceMesh`, or
`AbstractMesh` when only the specs are wanted).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

# (path regex, spec) -- first match wins
_RULES: list[tuple[str, tuple | None]] = [
    (r"embed$",                    ("model", "data")),
    (r"unembed$",                  ("data", "model")),
    (r"moe/router$",               (None, "model")),
    (r"moe/w_(gate|up)$",          ("model", "data", None)),
    (r"moe/w_down$",               ("model", "data", None)),
    (r"moe/shared/w_(gate|up)$",   ("data", "model")),
    (r"moe/shared/w_down$",        ("model", "data")),
    (r"mla/w_dq$",                 ("data", None)),
    (r"mla/w_uq$",                 (None, "model")),
    (r"mla/w_dkv$",                ("data", None)),
    (r"mla/w_uk$",                 ("model", None, None)),
    (r"mla/w_uv$",                 ("model", None, None)),
    (r"rg/w_(x|gate)$",            ("data", "model")),
    (r"rg/conv_w$",                (None, "model")),
    (r"rg/conv_b$",                ("model",)),
    (r"rg/w_(rg|ig)$",             ("model", None)),
    (r"rg/lam$",                   ("model",)),
    (r"rg/w_out$",                 ("model", "data")),
    (r"rwkv/mu$",                  (None, None)),
    (r"rwkv/w_(r|k|v|g|decay)$",   ("data", "model")),
    (r"rwkv/w_o$",                 ("model", "data")),
    (r"rwkv/(decay_base|bonus|ln_x)$", ("model",)),
    (r"cmix/w_kc$",                ("data", "model")),
    (r"cmix/w_vc$",                ("model", "data")),
    (r"cmix/mu_c$",                (None,)),
    (r"(wq|wk|wv)$",               ("data", "model")),
    (r"(wo)$",                     ("model", "data")),
    (r"b(q|k|v)$",                 ("model",)),
    (r"(w_gate|w_up)$",            ("data", "model")),
    (r"w_down$",                   ("model", "data")),
    (r"(gate_attn|gate_ffn)$",     ()),
    (r"(norm|ln|q_norm|kv_norm|final_norm)", None),  # replicate any norm
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group (the
    reference's `jax.sharding.AbstractMesh`)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _guard(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop mesh axes that are absent from the mesh (elastic scale-down)
    or do not divide the dim; align rank. A dim of size 1 is never split
    (on the reference's meshes no axis is that small)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec)[:len(shape)]
    spec = spec + (None,) * (len(shape) - len(spec))
    fixed: list = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                     if a in sizes)
        if not axes:
            fixed.append(None)
            continue
        # a one-axis tuple is that axis, as PartitionSpec normalises it
        ax = axes if isinstance(ax, tuple) and len(axes) > 1 else axes[0]
        size = math.prod(sizes[a] for a in axes)
        # (a dim of 1 is left whole: over axes of size 1 the split would
        # split nothing, and is one DTensor's views cannot merge away)
        fixed.append(ax if dim % size == 0 and dim >= size and dim > 1
                     else None)
    return tuple(fixed)


def _tree_map_with_path(fn, tree, path: tuple = ()):
    """fn("a/0/b", leaf) over a tree of dicts, tuples and lists, keeping
    its structure (the reference's `tree_map_with_path` with its path
    string)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def spec_for_param(path: str, shape: tuple, mesh) -> tuple:
    """The spec of the parameter leaf at `path` of (stacked) `shape`."""
    in_segment = path.startswith("segments/")
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = () if spec is None else tuple(spec)
            if in_segment:
                spec = (None,) + spec
            return _guard(spec, shape, mesh)
    return ()                                   # default: replicate


def param_specs(params: Any, mesh) -> Any:
    """The spec tree of a parameter tree (segment leaves get a leading
    replicated dim)."""
    return _tree_map_with_path(
        lambda p, leaf: spec_for_param(p, tuple(leaf.shape), mesh), params)


def _shardings(spec_fn, tree, mesh) -> Any:
    """The tree of `Sharding(mesh, spec_fn(path, leaf))` (a spec is a
    tuple, so a spec tree cannot be mapped as a tree)."""
    return _tree_map_with_path(
        lambda p, leaf: Sharding(mesh, spec_fn(p, leaf)), tree)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh (NamedSharding's counterpart)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of `spec` over `mesh`: per mesh dim, `Shard(d)`
    for the tensor dim d split over it, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec) if ax is not None and name in
                (ax if isinstance(ax, tuple) else (ax,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(params: Any, mesh) -> Any:
    return _shardings(lambda p, leaf: spec_for_param(p, tuple(leaf.shape),
                                                     mesh), params, mesh)


def batch_axes(mesh):
    """Axes used for data parallelism (pod included when present)."""
    return (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))


def _batch_entry(mesh):
    """The batch axes as a spec entry (one axis: its name, as
    PartitionSpec normalises a one-axis tuple)."""
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else ba[0]


def cache_specs(cache: Any, mesh) -> Any:
    """KV-cache / recurrent-state sharding: batch over data(+pod); the long
    sequence dim of attention caches over `model` (flash-decoding layout);
    rwkv/rg head-state over `model`."""
    return _tree_map_with_path(lambda p, leaf: _cache_spec(p, leaf, mesh),
                               cache)


def _cache_spec(path: str, leaf, mesh) -> tuple:
    """The spec of the cache leaf at `path` (see `cache_specs`)."""
    ba = batch_axes(mesh)
    shape = tuple(leaf.shape)  # leading dim = layer stack
    name = path.rsplit("/", 1)[-1]
    if name in ("k", "v"):              # (L, B, H, S, hd)
        return _guard((None, ba, None, "model", None), shape, mesh)
    if name in ("ckv", "kr"):           # (L, B, S, r)
        return _guard((None, ba, "model", None), shape, mesh)
    if name == "state" and len(shape) == 5:   # rwkv (L,B,H,hd,hd)
        return _guard((None, ba, "model", None, None), shape, mesh)
    if name == "state":                 # rg (L, B, DR)
        return _guard((None, ba, "model"), shape, mesh)
    if name == "conv":                  # (L, B, 3, DR)
        return _guard((None, ba, None, "model"), shape, mesh)
    if name in ("shift", "shift_c"):    # (L, B, D)
        return _guard((None, ba, None), shape, mesh)
    return _guard((None, ba), shape, mesh)


def cache_shardings(cache: Any, mesh) -> Any:
    return _shardings(lambda p, leaf: _cache_spec(p, leaf, mesh), cache,
                      mesh)


def input_sharding(mesh, rank: int) -> Sharding:
    """Token/label arrays: batch over data(+pod), rest replicated."""
    return Sharding(mesh, (_batch_entry(mesh),) + (None,) * (rank - 1))


def input_sharding_for(mesh, shape: tuple) -> Sharding:
    """Shape-aware input sharding: batch over data(+pod) where divisible
    (long_500k has global_batch=1: replicate), rest replicated."""
    return Sharding(mesh, _guard((batch_axes(mesh),), tuple(shape), mesh))


def logits_spec(mesh) -> tuple:
    return (_batch_entry(mesh), None, "model")


def layer_placements(sharding: Sharding, stacked: bool) -> tuple:
    """The placements of one layer's parameter from its leaf's sharding:
    a stacked leaf's leading (replicated) layer dim is dropped."""
    spec = sharding.spec[1:] if stacked else sharding.spec
    return placements(spec, sharding.mesh)


def distribute(t, sharding_or_placements, mesh=None):
    """`t` (the whole tensor, the same on every rank) as a DTensor of the
    given sharding: each rank keeps its shard; nothing is sent."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    if isinstance(sharding_or_placements, Sharding):
        mesh = sharding_or_placements.mesh
        pl = sharding_or_placements.placements
    else:
        pl = sharding_or_placements
    if isinstance(t, FakeTensor):        # no values: this rank's shard's
        shape = list(t.shape)            # shape (the splits divide)
        for n, p in zip(tuple(mesh.shape), pl):
            if isinstance(p, Shard):
                shape[p.dim] //= n
        return DTensor.from_local(t.new_empty(shape), mesh, list(pl),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, list(pl), src_data_rank=None)
