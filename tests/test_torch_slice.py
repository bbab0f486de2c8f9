"""The port's stripe slice end to end against the reference.

The same code, topology, payloads and failures go through the reference
`StripeCodec(backend="kernels")` (Pallas in interpret mode) and the port's
`StripeCodec(backend=TorchBackend("cpu"))` (the kernels' plain PyTorch
versions). Store contents, read bytes and launch counts per kernel name
must be equal: GF(2^8) coding is exact, so there is no tolerance.
"""
import numpy as np
import pytest

from repro.ckpt.store import BlockStore as RefStore
from repro.ckpt.stripe import StripeCodec as RefCodec
from repro.core import paper_schemes as ref_paper_schemes
from repro.kernels import ops as ref_ops
from repro.topo import Topology as RefTopology
from repro_torch.ckpt import BlockStore, StripeCodec, store_from_state
from repro_torch.ckpt.stripe import StripeMeta
from repro_torch.core import code_from_state
from repro_torch.io import NumpyBackend, TorchBackend
from repro_torch.kernels import ops
from repro_torch.topo import Topology

# (scheme, code name, clusters, nodes per cluster, block size, stripes)
CASES = [
    ("30-of-42", "UniLRC", 6, 8, 200, 5),
    ("30-of-42", "ALRC", 7, 8, 130, 3),
    ("180-of-210", "UniLRC", 10, 24, 64, 3),
]


def _state(store) -> dict:
    return {key: (store._block_node[key], store._blocks[key])
            for key in store._blocks}


class Pair:
    """The reference and the port driven side by side."""

    def __init__(self, scheme, name, clusters, npc, bs):
        r = ref_paper_schemes(scheme)[name]
        self.code = code_from_state(r.name, r.n, r.k, r.A, r.groups,
                                    r.checks, r.block_type, r.meta)
        self.ref = RefCodec(r, RefStore(RefTopology(clusters, npc)),
                            block_size=bs, backend="kernels",
                            max_batch_stripes=2)
        self.port = StripeCodec(self.code, BlockStore(Topology(clusters, npc)),
                                block_size=bs, backend=TorchBackend("cpu"),
                                max_batch_stripes=2)
        ref_ops.reset_kernel_launch_counts()
        ops.reset_kernel_launch_counts()

    def both(self, method, *args, **kw):
        """Call `method` on both codecs; results and launches must agree."""
        want = getattr(self.ref, method)(*args, **kw)
        got = getattr(self.port, method)(*self._port_args(args), **kw)
        assert dict(ops.KERNEL_LAUNCHES) == dict(ref_ops.KERNEL_LAUNCHES)
        return want, got

    @staticmethod
    def _port_args(args):
        def conv(a):
            if hasattr(a, "stripe_id") and hasattr(a, "nbytes"):
                return StripeMeta(a.stripe_id, a.nbytes, a.block_size)
            if isinstance(a, list) and a and hasattr(a[0], "stripe_id"):
                return [conv(x) for x in a]
            return a
        return [conv(a) for a in args]

    def stores_equal(self):
        assert _state(self.port.store) == _state(self.ref.store)
        assert self.port.store.failed_nodes == self.ref.store.failed_nodes

    def fail(self, node):
        self.ref.store.fail_node(node)
        self.port.store.fail_node(node)

    def heal(self, node):
        self.ref.store.heal_node(node)
        self.port.store.heal_node(node)


@pytest.mark.parametrize("scheme,name,clusters,npc,bs,S", CASES)
def test_slice_matches_reference(scheme, name, clusters, npc, bs, S):
    pair = Pair(scheme, name, clusters, npc, bs)
    k, n = pair.code.k, pair.code.n
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, S * k * bs - 77, dtype=np.uint8).tobytes()

    metas, port_metas = pair.both("write", payload)
    assert [m.nbytes for m in metas] == [m.nbytes for m in port_metas]
    pair.stores_equal()
    streamed, _ = pair.both("write_stream", payload[::-1], start_stripe=S,
                            window_stripes=2)
    pair.stores_equal()
    want, got = pair.both("read_all", metas)
    assert got == want == payload
    want, got = pair.both("read_all", streamed)
    assert got == want == payload[::-1]

    # one failed node: degraded read and fast-path recovery
    node = pair.ref.store.node_of(1, 3)
    pair.fail(node)
    want, got = pair.both("degraded_read", metas[1], 3)
    assert got == want == payload[(k + 3) * bs:(k + 4) * bs]
    lost = sorted(pair.ref.store.blocks_on_node(node))
    want, got = pair.both("recover_blocks", lost)
    assert got == want and len(got) == len(lost)

    # two erasures in one stripe: the pattern path
    other = next(b for b in range(n)
                 if pair.ref.store.node_of(1, b) != node
                 and pair.code.group_of(b) == pair.code.group_of(3))
    pair.ref.store.drop_block(1, other)
    pair.port.store.drop_block(1, other)
    want, got = pair.both("recover_blocks", [(1, 3), (1, other)])
    assert got == want
    placed = pair.both("rebuild_blocks", [(1, other)] + lost,
                       reader_cluster=0)
    assert placed[0] == placed[1] == len(lost) + 1
    pair.stores_equal()
    pair.heal(node)

    # a whole cluster lost
    cluster_nodes = range(npc)                      # cluster 0
    for nd in cluster_nodes:
        pair.fail(nd)
    pairs = sorted(key for nd in cluster_nodes
                   for key in pair.ref.store.blocks_on_node(nd))
    want, got = pair.both("recover_blocks", pairs, reader_cluster=1)
    assert got == want and len(got) == len(pairs)
    report, port_report = pair.both("rebuild_blocks_report", pairs[:5])
    assert report.requested == port_report.requested
    assert report.launches == port_report.launches
    for nd in cluster_nodes:
        pair.heal(nd)

    # delta-parity updates, then a node reconstruction
    new = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    want, got = pair.both("update_block", metas[0], 2, new)
    assert got == want
    want, got = pair.both("update_block", streamed[1], k - 1, new[::-1])
    assert got == want
    pair.stores_equal()
    pair.fail(node)
    want, got = pair.both("reconstruct_node", node)
    assert got == want
    pair.stores_equal()


def test_updates_match_a_host_reencode():
    """The port's delta-parity path leaves exactly the codeword a fresh
    encode of the updated data gives."""
    pair = Pair("30-of-42", "UniLRC", 6, 8, 96)
    code, codec = pair.code, pair.port
    rng = np.random.default_rng(3)
    metas = codec.write(rng.integers(0, 256, 2 * code.k * 96,
                                     dtype=np.uint8).tobytes())
    for b in (0, 7, 29):
        codec.update_block(metas[1], b, rng.integers(0, 256, 96,
                                                     dtype=np.uint8).tobytes())
    got = np.stack([np.frombuffer(codec.store.get(1, b), np.uint8)
                    for b in range(code.n)])
    want = NumpyBackend().encode_many(code, got[None, :code.k])[0]
    assert np.array_equal(got, want)


def test_reference_store_reads_back_through_the_port():
    """State carried across: a store and stripes the reference wrote, with
    a node down, read and recovered by the port."""
    pair = Pair("30-of-42", "UniLRC", 6, 8, 128)
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 3 * pair.code.k * 128,
                           dtype=np.uint8).tobytes()
    metas = pair.ref.write(payload)
    pair.ref.store.fail_node(pair.ref.store.node_of(0, 4))
    store = store_from_state(Topology(6, 8), _state(pair.ref.store),
                             pair.ref.store.failed_nodes)
    codec = StripeCodec(pair.code, store, block_size=128,
                        backend=TorchBackend("cpu"))
    port_metas = [StripeMeta(m.stripe_id, m.nbytes, m.block_size)
                  for m in metas]
    assert codec.read_all(port_metas) == payload
    lost = store.blocks_on_node(pair.ref.store.node_of(0, 4))
    rec = codec.recover_blocks(lost)
    assert rec == pair.ref.recover_blocks(lost)
    with pytest.raises(ValueError):
        store_from_state(Topology(6, 8), {(0, 0): (99, b"x")})


def test_stream_launch_bound():
    """A streamed write of S stripes costs ceil(S / window) encodes."""
    pair = Pair("30-of-42", "UniLRC", 6, 8, 64)
    codec = pair.port
    ops.reset_kernel_launch_counts()
    codec.write_stream(bytes(7 * pair.code.k * 64), window_stripes=2)
    assert dict(ops.KERNEL_LAUNCHES) == {"gf_bitmatmul": 4}


def test_gateway_folds_and_reads_match_reference():
    """Gateway pre-folds (relaxed placement, XOR plans), normal and
    straggler reads: same bytes, launches and traffic as the reference."""
    from repro.core.placement import place_unilrc_relaxed as ref_relaxed
    from repro_torch.core import place_unilrc_relaxed

    r = ref_paper_schemes("30-of-42")["UniLRC"]
    code = code_from_state(r.name, r.n, r.k, r.A, r.groups, r.checks,
                           r.block_type, r.meta)
    ref = RefCodec(r, RefStore(RefTopology(12, 4)), block_size=96,
                   backend="kernels", placement=ref_relaxed(r, 2),
                   gateway_aggregation=True)
    port = StripeCodec(code, BlockStore(Topology(12, 4)), block_size=96,
                       backend=TorchBackend("cpu"),
                       placement=place_unilrc_relaxed(code, 2),
                       gateway_aggregation=True)
    pair = Pair.__new__(Pair)
    pair.code, pair.ref, pair.port = code, ref, port
    ref_ops.reset_kernel_launch_counts()
    ops.reset_kernel_launch_counts()
    payload = np.random.default_rng(9).integers(
        0, 256, 2 * code.k * 96, dtype=np.uint8).tobytes()
    metas, _ = pair.both("write", payload)
    for store in (ref.store, port.store):
        store.fail_node(store.node_of(0, 1))
        store.set_latency(store.node_of(1, 4), 0.5)
    want, got = pair.both("recover_blocks", [(0, 1)], reader_cluster=0)
    assert got == want
    want, got = pair.both("normal_read", metas[0], reader_cluster=0)
    assert got == want == payload[:code.k * 96]
    for store in (ref.store, port.store):
        store.heal_node(store.node_of(0, 1))
    want, got = pair.both("straggler_read", metas[1], 0, reader_cluster=0)
    assert got == want
    for field in ("inner_bytes", "cross_bytes", "aggregated_bytes", "reads"):
        assert getattr(port.store.traffic, field) == \
            getattr(ref.store.traffic, field), field
    assert port.store.traffic.aggregated_bytes > 0
