"""In-memory block store for the port's EC stripe layer.

Mirrors the paper's prototype (§4.2): a coordinator holds metadata; proxies
(one per cluster) hold blocks on nodes. `BlockStore` tracks per-node failure
and per-node latency (straggler simulation) so degraded reads,
reconstruction, and straggler-avoiding reads are exercised for real.
Traffic accounting distinguishes inner- vs cross-cluster bytes — the
quantity the paper's topology locality minimises — plus the aggregated
tier: cross bytes that shipped as gateway-pre-folded blocks.

A copy of `repro.ckpt.store` for the PyTorch port: the in-memory
`BlockStore` and the durable `DiskBlockStore`, whose directory layout is
the reference's, so each package reopens the other's directory.
`store_from_state` loads a store from another package's blocks and
failed-node set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import threading
from collections.abc import Callable, Iterator, Mapping

from repro_torch.topo import Topology


class NodeFailure(Exception):
    """Raised when reading a block from a failed node."""


@dataclasses.dataclass
class TrafficDelta:
    """Thread-local traffic attribution window (see TrafficStats.scoped):
    only bytes moved by the OPENING thread while the scope is active land
    here, so one shard's flush can account its own traffic exactly while
    other shards move bytes concurrently."""
    inner_bytes: int = 0
    cross_bytes: int = 0
    aggregated_bytes: int = 0
    reads: int = 0


@dataclasses.dataclass
class TrafficStats:
    inner_bytes: int = 0
    cross_bytes: int = 0
    aggregated_bytes: int = 0   # subset of cross_bytes: pre-folded blocks
    reads: int = 0

    def __post_init__(self):
        # Mutation is locked (sharded flushes read from worker
        # threads); the per-thread scope stack rides a threading.local so
        # scoped attribution never sees another thread's bytes.
        self._lock = threading.Lock()
        self._scopes = threading.local()

    def _scope_stack(self) -> list[TrafficDelta]:
        stack = getattr(self._scopes, "stack", None)
        if stack is None:
            stack = self._scopes.stack = []
        return stack

    @contextlib.contextmanager
    def scoped(self) -> Iterator[TrafficDelta]:
        """Thread-local delta collector: every add/add_many/add_shipped
        issued by THIS thread inside the scope also lands on the yielded
        `TrafficDelta`. The concurrent-safe replacement for the
        before/after field-snapshot idiom, which under the shard worker
        pool would fold every other shard's traffic into the delta."""
        delta = TrafficDelta()
        stack = self._scope_stack()
        stack.append(delta)
        try:
            yield delta
        finally:
            stack.remove(delta)

    def add(self, nbytes: int, cross: bool):
        with self._lock:
            self.reads += 1
            if cross:
                self.cross_bytes += nbytes
            else:
                self.inner_bytes += nbytes
        for delta in self._scope_stack():
            delta.reads += 1
            if cross:
                delta.cross_bytes += nbytes
            else:
                delta.inner_bytes += nbytes

    def add_many(self, reads: int, inner_bytes: int, cross_bytes: int):
        """One accounting pass for a whole `get_many` batch."""
        with self._lock:
            self.reads += reads
            self.inner_bytes += inner_bytes
            self.cross_bytes += cross_bytes
        for delta in self._scope_stack():
            delta.reads += reads
            delta.inner_bytes += inner_bytes
            delta.cross_bytes += cross_bytes

    def add_shipped(self, nbytes: int):
        """A gateway-pre-folded block crossing into the reader's cluster:
        cross-tier bytes that never touched the store's read path (the
        fold output ships, not its inputs)."""
        with self._lock:
            self.cross_bytes += nbytes
            self.aggregated_bytes += nbytes
        for delta in self._scope_stack():
            delta.cross_bytes += nbytes
            delta.aggregated_bytes += nbytes


class BlockStore:
    """In-memory block store with failure + straggler simulation."""

    def __init__(self, topo: Topology):
        self.topo = topo
        self._blocks: dict[tuple, bytes] = {}       # (stripe, block) -> bytes
        self._block_node: dict[tuple, int] = {}
        self._failed: set[int] = set()
        self._latency: dict[int, float] = {}        # node -> simulated sec
        self.traffic = TrafficStats()
        self._mutation_listeners: list[
            tuple[Callable[[int, int], None],
                  Callable[[list[tuple[int, int]]], None] | None]] = []

    # -- mutation listeners --------------------------------------------------
    def add_mutation_listener(
            self, cb: Callable[[int, int], None], *,
            batch: Callable[[list[tuple[int, int]]], None] | None = None
            ) -> None:
        """Register `cb(stripe, block)` to fire on EVERY content mutation
        of that block — put (write, update, rebuild re-place), drop, and
        node-wide delete. The hot-block cache hangs its invalidation here,
        which is what makes cached/uncached byte-identity an invariant
        rather than a convention: no mutation path can forget to
        invalidate, because the store itself notifies.

        `batch` optionally handles bulk mutations: `put_many` delivers
        its whole [(stripe, block), ...] list in ONE call instead of
        firing `cb` once per block (a 210-block stripe would otherwise
        cost 210 listener round-trips per streamed window). Listeners
        without a batch handler still see every pair, one call each —
        exactness is never traded for batching."""
        self._mutation_listeners.append((cb, batch))

    def _notify_mutation(self, stripe: int, block: int) -> None:
        for cb, _batch in self._mutation_listeners:
            cb(stripe, block)

    def _notify_mutation_many(self, pairs: list[tuple[int, int]]) -> None:
        for cb, batch in self._mutation_listeners:
            if batch is not None:
                batch(pairs)
            else:
                for stripe, block in pairs:
                    cb(stripe, block)

    # -- placement ---------------------------------------------------------
    def _put_nolisten(self, stripe: int, block: int, node: int, data):
        """Store one payload + index entry WITHOUT notifying listeners —
        the shared body of `put` (per-block notify) and `put_many` (one
        batched notify). The only point where the in-memory and disk
        tiers differ on the write path."""
        self._blocks[(stripe, block)] = bytes(data)
        self._block_node[(stripe, block)] = node

    def put(self, stripe: int, block: int, node: int, data: bytes):
        self._put_nolisten(stripe, block, node, data)
        self._notify_mutation(stripe, block)

    def put_many(self, entries) -> int:
        """Bulk landing: place every `(stripe, block, node, data)` entry,
        then fire ONE batched mutation notification for the whole set.
        `data` is anything `bytes()` accepts (numpy row views included —
        the streamed checkpoint writer hands codeword views straight
        through, no per-block `.tobytes()` staging). Per-entry semantics
        are identical to `put`; only the listener fan-out is batched.
        Returns the number of blocks placed."""
        pairs: list[tuple[int, int]] = []
        for stripe, block, node, data in entries:
            self._put_nolisten(stripe, block, node, data)
            pairs.append((stripe, block))
        if pairs:
            self._notify_mutation_many(pairs)
        return len(pairs)

    def node_of(self, stripe: int, block: int) -> int:
        return self._block_node[(stripe, block)]

    def blocks_on_node(self, node: int) -> list[tuple]:
        return [k for k, nd in self._block_node.items() if nd == node]

    def nodes_holding(self, stripe: int) -> set[int]:
        """Nodes currently holding any block of `stripe` — the public view
        the rebuild engine consults to avoid co-locating re-placed blocks
        of one stripe (the invariant StripeCodec's constructor validates)."""
        return {nd for (s, _b), nd in self._block_node.items() if s == stripe}

    def nodes_holding_many(self, stripes: set[int]) -> dict[int, set[int]]:
        """nodes_holding for many stripes in ONE index pass — the rebuild
        engine heals S stripes per call, and a per-stripe scan would make
        node repair O(S * total_blocks)."""
        out: dict[int, set[int]] = {s: set() for s in stripes}
        for (s, _b), nd in self._block_node.items():
            if s in stripes:
                out[s].add(nd)
        return out

    # -- failure / straggler injection --------------------------------------
    def fail_node(self, node: int):
        self._failed.add(node)

    def heal_node(self, node: int):
        self._failed.discard(node)

    def set_latency(self, node: int, seconds: float):
        self._latency[node] = seconds

    @property
    def failed_nodes(self) -> frozenset:
        return frozenset(self._failed)

    def available(self, stripe: int, block: int) -> bool:
        key = (stripe, block)
        return key in self._blocks and self._block_node[key] not in self._failed

    def latency_of(self, stripe: int, block: int) -> float:
        return self._latency.get(self._block_node[(stripe, block)], 0.0)

    # -- reads --------------------------------------------------------------
    def _payload(self, key: tuple[int, int], node: int) -> bytes:
        """Fetch the stored bytes for an index entry known to be live —
        the only point where the in-memory and disk tiers differ."""
        return self._blocks[key]

    def get(self, stripe: int, block: int, *,
            reader_cluster: int | None = None) -> bytes:
        key = (stripe, block)
        node = self._block_node.get(key)
        if node is None:
            raise KeyError(key)
        if node in self._failed:
            raise NodeFailure(f"node {node} (stripe {stripe} block {block})")
        data = self._payload(key, node)
        cross = (reader_cluster is not None
                 and self.topo.cluster_of(node) != reader_cluster)
        self.traffic.add(len(data), cross)
        return data

    def get_many(self, pairs, *, reader_cluster: int | None = None
                 ) -> dict[tuple[int, int], bytes]:
        """Batched read of many (stripe, block) pairs (deduplicated).

        ONE failure-set check for the whole batch — every pair is
        validated against the index and the failed-node set before any
        payload is touched, so a doomed batch raises with zero traffic
        recorded — and ONE TrafficStats pass at the end instead of a
        per-block `add`. This is the read path under the batched engine:
        a plan group's sources across S stripes are one call here."""
        nodes: dict[tuple[int, int], int] = {}
        for key in dict.fromkeys(pairs):
            node = self._block_node.get(key)
            if node is None:
                raise KeyError(key)
            nodes[key] = node
        for (stripe, block), node in nodes.items():
            if node in self._failed:
                raise NodeFailure(
                    f"node {node} (stripe {stripe} block {block})")
        out: dict[tuple[int, int], bytes] = {}
        inner = cross = 0
        cluster_of = self.topo.cluster_of
        for key, node in nodes.items():
            data = self._payload(key, node)
            out[key] = data
            if reader_cluster is not None \
                    and cluster_of(node) != reader_cluster:
                cross += len(data)
            else:
                inner += len(data)
        self.traffic.add_many(len(out), inner, cross)
        return out

    def drop_block(self, stripe: int, block: int):
        """Simulate loss of a single block replica (latent sector error /
        scrub-detected corruption) while its node stays up. Lets tests and
        failure injection construct arbitrary per-stripe erasure patterns."""
        self._blocks.pop((stripe, block), None)
        self._block_node.pop((stripe, block), None)
        self._notify_mutation(stripe, block)

    def delete_node_blocks(self, node: int):
        """Simulate permanent loss of a node's disks."""
        for key in self.blocks_on_node(node):
            del self._blocks[key]
            del self._block_node[key]
            self._notify_mutation(*key)


class DiskBlockStore(BlockStore):
    """Durable tier: blocks live under root/node_<i>/s<stripe>_b<block>.

    Inherits the in-memory index for placement/failure bookkeeping but
    persists payloads to disk, so a process restart (the checkpoint/restart
    drill in the reference's examples/train_with_failures.py) can
    re-open the store.
    """

    def __init__(self, topo: Topology, root: str | os.PathLike):
        super().__init__(topo)
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, stripe: int, block: int, node: int) -> pathlib.Path:
        d = self.root / f"node_{node:04d}"
        d.mkdir(exist_ok=True)
        return d / f"s{stripe:06d}_b{block:04d}"

    def _put_nolisten(self, stripe: int, block: int, node: int, data):
        # put/put_many inherit from BlockStore and keep their listener
        # semantics; only the payload landing differs (file vs dict).
        self._path(stripe, block, node).write_bytes(data)
        self._blocks[(stripe, block)] = b""           # payload on disk
        self._block_node[(stripe, block)] = node

    def _payload(self, key: tuple[int, int], node: int) -> bytes:
        return self._path(key[0], key[1], node).read_bytes()

    def reopen(self):
        """Rebuild the index from the directory tree (restart path)."""
        self._blocks.clear()
        self._block_node.clear()
        for nd in sorted(self.root.glob("node_*")):
            node = int(nd.name.split("_")[1])
            for f in nd.iterdir():
                s, b = f.name[1:].split("_b")
                self._blocks[(int(s), int(b))] = b""
                self._block_node[(int(s), int(b))] = node

    def drop_block(self, stripe: int, block: int):
        node = self._block_node.get((stripe, block))
        if node is not None:
            p = self._path(stripe, block, node)
            if p.exists():
                p.unlink()
        super().drop_block(stripe, block)

    def delete_node_blocks(self, node: int):
        for key in self.blocks_on_node(node):
            s, b = key
            p = self._path(s, b, node)
            if p.exists():
                p.unlink()
            del self._blocks[key]
            del self._block_node[key]
            self._notify_mutation(s, b)


def store_from_state(topo: Topology,
                     blocks: Mapping[tuple[int, int], tuple[int, bytes]],
                     failed_nodes=()) -> BlockStore:
    """A `BlockStore` holding `{(stripe, block): (node, payload)}` with
    `failed_nodes` down — the state of a store another package wrote,
    given as plain values. Payloads are copied; no listener fires."""
    store = BlockStore(topo)
    for (stripe, block), (node, data) in blocks.items():
        node = int(node)
        if not 0 <= node < topo.num_nodes:
            raise ValueError(f"node {node} outside the {topo.num_nodes}-node "
                             f"topology (stripe {stripe} block {block})")
        store._put_nolisten(int(stripe), int(block), node, data)
    for node in failed_nodes:
        store.fail_node(int(node))
    return store
