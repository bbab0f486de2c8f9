"""The port's checkpoint serializer and `CheckpointManager` against the
reference's, on the CPU. Both are byte paths: buffers, manifests and
restored tensors must be equal, byte for byte.

The weights are the reference's `init_params` for llama3.2 SMOKE (every
leaf bf16) and for recurrentgemma SMOKE (bf16 leaves beside the rg
blocks' fp32 `lam`), carried into the port with `params_from_jax`; the
scenario (code, topology, block size, failed node) is the reference's
restart drill (`repro.launch.train`): save, lose a node, restore
degraded, rebuild.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefManager
from repro.ckpt.serialize import Manifest as RefManifest
from repro.ckpt.serialize import deserialize_tree as ref_deserialize
from repro.ckpt.serialize import serialize_tree as ref_serialize
from repro.ckpt.store import BlockStore as RefStore
from repro.configs import get_config as ref_get_config
from repro.core import make_unilrc as ref_make_unilrc
from repro.models import init_params as ref_init_params
from repro.topo import Topology as RefTopology
from repro_torch.ckpt import (BlockStore, CheckpointManager, Manifest,
                              deserialize_tree, serialize_tree)
from repro_torch.configs import get_config
from repro_torch.core import make_unilrc
from repro_torch.io import TorchBackend
from repro_torch.models import params_from_jax, params_to_tree
from repro_torch.topo import Topology

BLOCK = 4096


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def _weights(arch):
    """(reference tree, the port's tree of the same weights)."""
    params = ref_init_params(ref_get_config(arch, smoke=True),
                             jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), params)
    model = params_from_jax(get_config(arch, smoke=True), host, "cpu")
    return params, params_to_tree(model)


@pytest.fixture(scope="module")
def weights():
    return _weights("llama3.2-3b")


@pytest.fixture(scope="module")
def rg_weights():
    """recurrentgemma SMOKE: fp32 `lam` leaves beside bf16 ones."""
    return _weights("recurrentgemma-9b")


def _trees(which, weights, rg_weights):
    if which == "weights":
        return weights
    if which == "rg_weights":
        return rg_weights
    return _mixed(), _mixed_torch(_mixed())


def _mixed():
    """A tree with every leaf kind: nested dicts, tuples and a list; fp32,
    int32, uint8 and bf16 leaves; a 0-d leaf; keys out of sorted order."""
    rng = np.random.default_rng(3)
    return {
        "z": (rng.normal(size=(3, 5)).astype(np.float32),
              [rng.integers(0, 9, (4,)).astype(np.int32),
               np.array(7, np.int32)]),
        "a": {"w": rng.normal(size=(2, 6)).astype(np.float32),
              "bytes": rng.integers(0, 256, (11,), dtype=np.uint8)},
        "b": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16),
    }


def _mixed_torch(tree):
    def conv(leaf):
        arr = np.asarray(leaf)
        if arr.dtype == jnp.bfloat16:
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(arr.copy())
    return {"z": (conv(tree["z"][0]), [conv(x) for x in tree["z"][1]]),
            "a": {k: conv(v) for k, v in tree["a"].items()},
            "b": conv(tree["b"])}


@pytest.mark.parametrize("which", ["weights", "mixed", "rg_weights"])
def test_serialize_is_byte_equal(weights, rg_weights, which):
    ref_tree, port_tree = _trees(which, weights, rg_weights)
    want_buf, want_man, _ = ref_serialize(ref_tree)
    buf, man, _ = serialize_tree(port_tree)
    assert buf == want_buf
    assert man.entries == want_man.entries
    assert man.total_bytes == want_man.total_bytes == len(buf)
    if which == "weights":
        assert man.entries[0][0] == "embed"
        assert any(e[0] == "segments/0/0/attn/wq" and e[2] == "bfloat16"
                   for e in man.entries)
    if which == "rg_weights":
        dtypes = {e[0]: e[2] for e in man.entries}
        assert dtypes["segments/0/0/rg/lam"] == "float32"
        assert dtypes["segments/1/1/rg/lam"] == "float32"
        assert dtypes["segments/0/0/rg/w_rg"] == "bfloat16"
        assert dtypes["segments/0/2/attn/wq"] == "bfloat16"


@pytest.mark.parametrize("which", ["weights", "mixed", "rg_weights"])
def test_each_package_reads_the_others_buffer(weights, rg_weights, which):
    ref_tree, port_tree = _trees(which, weights, rg_weights)
    ref_buf, ref_man, ref_treedef = ref_serialize(ref_tree)
    buf, man, treedef = serialize_tree(port_tree)
    # the port reads the reference's buffer through its JSON manifest
    got = deserialize_tree(ref_buf, Manifest.from_json(ref_man.to_json()),
                           treedef)
    # the reference reads the port's buffer through the port's manifest
    back = ref_deserialize(bytearray(buf),
                           RefManifest.from_json(man.to_json()), ref_treedef)
    want = jax.tree_util.tree_leaves(port_tree)
    for a, b, c in zip(want, jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))
        c = np.asarray(c)
        c = c.view(np.uint16) if c.dtype == jnp.bfloat16 else c
        assert np.array_equal(_bits(a), c)


def test_deserialize_shares_a_writable_buffer():
    buf, man, treedef = serialize_tree({"w": torch.arange(6.0)})
    shared = bytearray(buf)
    tree = deserialize_tree(shared, man, treedef)
    shared[:4] = np.float32(9.0).tobytes()
    assert tree["w"][0] == 9.0
    copied = deserialize_tree(bytes(buf), man, treedef)
    assert torch.equal(copied["w"], torch.arange(6.0))


class Drill:
    """The reference's and the port's manager on the same code, topology
    and weights."""

    def __init__(self, weights):
        self.ref_tree, self.tree = weights
        self.ref = RefManager(RefStore(RefTopology(4, 8)),
                              ref_make_unilrc(1, 4), block_size=BLOCK,
                              backend="kernels")
        self.port = CheckpointManager(BlockStore(Topology(4, 8)),
                                      make_unilrc(1, 4), block_size=BLOCK,
                                      backend=TorchBackend("cpu"))
        assert self.port.save(self.tree, step=0) == \
            self.ref.save(self.ref_tree, step=0)

    def fail(self, stripe, block):
        node = self.port.store.node_of(stripe, block)
        assert node == self.ref.store.node_of(stripe, block)
        self.port.store.fail_node(node)
        self.ref.store.fail_node(node)


@pytest.fixture
def drill(weights):
    return Drill(weights)


def test_save_lands_the_same_blocks(drill):
    assert drill.port.stripes_of(0)[0].nbytes == drill.ref.stripes_of(0)[0].nbytes
    assert drill.port.store._blocks.keys() == drill.ref.store._blocks.keys()
    for key, data in drill.ref.store._blocks.items():
        assert bytes(drill.port.store._blocks[key]) == bytes(data), key
    assert drill.port.latest_step() == drill.ref.latest_step() == 0
    assert drill.port.verify(0) and not drill.port.verify(1)


def test_degraded_restore_is_byte_exact_and_cluster_local(drill):
    drill.fail(0, 0)
    got, report = drill.port.restore()
    want, ref_report = drill.ref.restore()
    assert report.degraded and report.degraded_blocks == \
        ref_report.degraded_blocks > 0
    assert report.total_blocks_read == ref_report.total_blocks_read
    assert report.cross_cluster_bytes == ref_report.cross_cluster_bytes == 0
    assert report.inner_cluster_bytes == ref_report.inner_cluster_bytes
    saved = jax.tree_util.tree_leaves(drill.tree)
    for a, b, c in zip(saved, jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want)):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        assert np.array_equal(_bits(a), _bits(b))
        assert np.array_equal(_bits(b), np.asarray(c).view(np.uint16))


def test_reconstruct_failures_rebuilds_what_the_reference_rebuilds(drill):
    drill.fail(1, 3)
    rebuilt = drill.port.reconstruct_failures()
    assert rebuilt == drill.ref.reconstruct_failures() > 0
    assert not drill.port.store.failed_nodes
    got, report = drill.port.restore(0)
    assert report.degraded_blocks == 0
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(
        jax.tree_util.tree_leaves(drill.tree),
        jax.tree_util.tree_leaves(got)))


def test_manager_without_a_code_chooses_the_references(weights):
    """`code=None` picks the code `choose_code` picks in the reference, and
    a checkpoint saved with it comes back byte for byte."""
    mgr = CheckpointManager(BlockStore(Topology(4, 8)), block_size=BLOCK,
                            backend=TorchBackend("cpu"))
    ref = RefManager(RefStore(RefTopology(4, 8)), block_size=BLOCK,
                     backend="numpy")
    assert (mgr.code.name, mgr.code.n, mgr.code.k) == \
        (ref.code.name, ref.code.n, ref.code.k)
    assert np.array_equal(mgr.code.A, ref.code.A)
    with pytest.raises(KeyError):
        mgr.restore()
    with pytest.raises(KeyError):
        mgr.stripes_of(3)
    _, tree = weights
    mgr.save(tree, step=1)
    got, report = mgr.restore(1)
    assert report.degraded_blocks == 0
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(got)))


def test_mixed_dtype_checkpoint_restores_degraded_across_packages(
        rg_weights):
    """recurrentgemma's tree (fp32 `lam` among bf16 leaves) through both
    managers: the same blocks land, and after one node is lost each
    package restores degraded the leaves the other saved, byte for byte,
    with zero cross-cluster bytes."""
    drill = Drill(rg_weights)
    for key, data in drill.ref.store._blocks.items():
        assert bytes(drill.port.store._blocks[key]) == bytes(data), key
    drill.fail(0, 0)
    got, report = drill.port.restore()
    want, ref_report = drill.ref.restore()
    assert report.degraded_blocks == ref_report.degraded_blocks > 0
    assert report.cross_cluster_bytes == ref_report.cross_cluster_bytes == 0
    dtypes = set()
    for a, b, c in zip(jax.tree_util.tree_leaves(drill.tree),
                       jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want), strict=True):
        assert b.dtype == a.dtype and b.shape == a.shape
        dtypes.add(a.dtype)
        c = np.asarray(c)
        c = c.view(np.uint16) if c.dtype == jnp.bfloat16 else c
        assert np.array_equal(_bits(a), _bits(b))
        assert np.array_equal(_bits(b), c)
    assert dtypes == {torch.bfloat16, torch.float32}
