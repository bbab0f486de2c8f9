"""Partitioning of the port against the reference's, leaf by leaf, for
every arch at full width on both production meshes: parameter specs of
the abstract parameter tree, cache specs of the decode_32k cache and
input specs at every shape. The reference is called on a
`jax.sharding.AbstractMesh`, the port on an `AbstractMesh` of the same
axis sizes (the specs need no devices)."""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as ref_config
from repro.models import partitioning as RP
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import init_cache as ref_init_cache
from repro_torch.configs import all_archs, get_config
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import partitioning as PT
from repro_torch.models.model import (_block_cache_spec, abstract_params,
                                      layer_shardings, Transformer)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names), PT.AbstractMesh(shape, names)


def _leaves(ref_tree):
    return jax.tree_util.tree_leaves_with_path(
        ref_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _at(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return tree


def _abstract_cache(cfg, B, S):
    """The port's decode cache as meta tensors (its shapes, no storage)."""
    return tuple(
        tuple({name: torch.empty((seg.count, *shape), dtype=dtype,
                                 device="meta")
               for name, (shape, dtype) in _block_cache_spec(
                   kind, cfg, B, S).items()} for kind in seg.blocks)
        for seg in cfg.segments)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_param_specs_match_the_reference(arch, mesh_kind):
    ref_mesh, mesh = _meshes(mesh_kind)
    ref = RP.param_specs(ref_abstract_params(ref_config(arch)), ref_mesh)
    port = PT.param_specs(abstract_params(get_config(arch)), mesh)
    leaves = _leaves(ref)
    assert leaves
    for path, spec in leaves:
        assert _at(port, path) == tuple(spec), (arch, path)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_cache_and_input_specs_match_the_reference(arch, mesh_kind):
    ref_mesh, mesh = _meshes(mesh_kind)
    cfg, rcfg = get_config(arch), ref_config(arch)
    spec = SHAPES["decode_32k"]
    if cfg.has_decode:
        ref = RP.cache_specs(ref_init_cache(rcfg, spec.global_batch,
                                            spec.seq_len, abstract=True),
                             ref_mesh)
        port = PT.cache_specs(_abstract_cache(cfg, spec.global_batch,
                                              spec.seq_len), mesh)
        leaves = _leaves(ref)
        assert leaves
        for path, s in leaves:
            assert _at(port, path) == tuple(s), (arch, path)
    for shape in SHAPES.values():
        for dims in ((shape.global_batch, shape.seq_len),
                     (shape.global_batch, shape.seq_len, cfg.d_model),
                     (shape.global_batch, 1)):
            ref = RP.input_sharding_for(ref_mesh, dims)
            assert PT.input_sharding_for(mesh, dims).spec == tuple(ref.spec)
    assert PT.input_sharding(mesh, 2).spec == tuple(
        RP.input_sharding(ref_mesh, 2).spec)
    assert PT.logits_spec(mesh) == tuple(RP.logits_spec(ref_mesh))
    assert PT.batch_axes(mesh) == RP.batch_axes(ref_mesh)


def test_layer_placements_drop_the_stacked_dim():
    """A layer's parameter takes its stacked leaf's spec without the
    leading layer dim; placements put Shard(d) on the mesh dim that
    splits tensor dim d."""
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = _meshes("multi")
    model = Transformer(get_config("llama3.2-3b"), None, "meta")
    names = [n for n, _ in model.named_parameters()]
    shardings = dict(zip(names, layer_shardings(model, mesh)))
    assert shardings["blocks.0.attn.wq"].spec == ("data", "model")
    assert shardings["blocks.0.attn.wq"].placements == (
        Replicate(), Shard(0), Shard(1))
    assert shardings["embed"].spec == ("model", "data")
    assert shardings["embed"].placements == (Replicate(), Shard(1),
                                             Shard(0))
    assert shardings["blocks.3.norm1"].spec == (None,)
    batch = PT.input_sharding(mesh, 2)
    assert batch.spec == (("pod", "data"), None)
    assert batch.placements == (Shard(0), Shard(0), Replicate())
