"""CheckpointManager: erasure-coded checkpoint/restart (port of
`repro.ckpt.manager`).

Ties the stripe layer together: serialize a tree (model weights, train
state) -> stripe it with UniLRC across the cluster topology -> restore
with degraded reads when nodes are down -> rebuild after failures:

  save(tree, step)                  -> encode + place stripes
  restore(step) -> (tree, report)   -> normal read; transparently degraded
                                       when <= f nodes are failed
  reconstruct_failures()            -> re-protect (paper: reconstruction)
  verify(step)                      -> every stripe still decodes

Restores are deterministic bytes: the restored tree is bit-identical to
what was saved. `code=None` picks a code from the topology with
`choose_code` (the smallest UniLRC meeting the rate target, MTTDL-checked).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from repro_torch.core.codes import Code
from repro_torch.io.backend import Backend, resolve_backend

from .serialize import Manifest, TreeDef, deserialize_tree, serialize_tree
from .store import BlockStore, NodeFailure
from .stripe import StripeCodec, StripeMeta, choose_code


@dataclasses.dataclass
class RestoreReport:
    step: int
    total_blocks_read: int
    degraded_blocks: int
    cross_cluster_bytes: int
    inner_cluster_bytes: int
    wall_seconds: float

    @property
    def degraded(self) -> bool:
        return self.degraded_blocks > 0


@dataclasses.dataclass
class _Saved:
    metas: list[StripeMeta]
    manifest: Manifest
    treedef: TreeDef


class CheckpointManager:
    def __init__(self, store: BlockStore, code: Code | None = None, *,
                 block_size: int = 1 << 18,
                 backend: Backend | str | None = None):
        self.store = store
        self.code = code or choose_code(store.topo)
        self.block_size = block_size
        self.codec = StripeCodec(self.code, store, block_size=block_size,
                                 backend=resolve_backend(backend))
        self._saved: dict[int, _Saved] = {}
        self._next_stripe = 0

    # -- save ----------------------------------------------------------------
    def write_checkpoint(self, buf: bytes, *,
                         window_stripes: int | None = None
                         ) -> list[StripeMeta]:
        """Stream a raw checkpoint buffer through the fused encode+put path
        (`StripeCodec.write_stream`). Returns the StripeMeta list; the
        stripe cursor advances just like `save`."""
        metas = self.codec.write_stream(
            buf, start_stripe=self._next_stripe,
            window_stripes=window_stripes)
        self._next_stripe += len(metas)
        return metas

    def save(self, state: Any, step: int) -> int:
        """Returns the number of stripes written."""
        buf, manifest, treedef = serialize_tree(state)
        metas = self.write_checkpoint(buf)
        self._saved[step] = _Saved(metas, manifest, treedef)
        return len(metas)

    @property
    def saved_steps(self) -> list[int]:
        return sorted(self._saved)

    def stripes_of(self, step: int) -> list[StripeMeta]:
        """StripeMeta list of one checkpoint."""
        if step not in self._saved:
            raise KeyError(f"no checkpoint for step {step}")
        return list(self._saved[step].metas)

    def latest_step(self) -> int | None:
        return max(self._saved) if self._saved else None

    # -- restore ---------------------------------------------------------------
    def restore(self, step: int | None = None,
                reader_cluster: int | None = None
                ) -> tuple[Any, RestoreReport]:
        """Restore a tree (CPU tensors); any unavailable block is
        degraded-read from its local group (zero cross-cluster traffic
        under UniLRC placement)."""
        if step is None:
            step = self.latest_step()
        if step is None or step not in self._saved:
            raise KeyError(f"no checkpoint for step {step}")
        sv = self._saved[step]
        t0 = time.perf_counter()
        tr0 = dataclasses.replace(self.store.traffic)

        degraded = 0
        total = 0
        # one writable buffer (the tensors share it), uninitialised and
        # filled stripe by stripe: the host holds one copy of the
        # checkpoint, not the stripes' parts and their join at once
        buf = np.empty(sum(meta.nbytes for meta in sv.metas), np.uint8)
        off = 0
        for meta in sv.metas:
            for b in range(self.code.k):
                total += 1
                if not self.store.available(meta.stripe_id, b):
                    degraded += 1
            part = self.codec.normal_read(meta, reader_cluster=reader_cluster)
            buf[off:off + len(part)] = np.frombuffer(part, np.uint8)
            off += len(part)
        state = deserialize_tree(
            memoryview(buf)[:min(off, sv.manifest.total_bytes)],
            sv.manifest, sv.treedef)
        tr1 = self.store.traffic
        report = RestoreReport(
            step=step, total_blocks_read=total, degraded_blocks=degraded,
            cross_cluster_bytes=tr1.cross_bytes - tr0.cross_bytes,
            inner_cluster_bytes=tr1.inner_bytes - tr0.inner_bytes,
            wall_seconds=time.perf_counter() - t0)
        return state, report

    # -- repair ----------------------------------------------------------------
    def reconstruct_failures(self) -> int:
        """Rebuild all blocks on failed nodes onto healthy same-cluster
        nodes; heals the store's redundancy level. Returns blocks rebuilt."""
        for node in sorted(self.store.failed_nodes):
            self.store.delete_node_blocks(node)  # disks are gone
            self.store.heal_node(node)           # slot replaced by fresh node
        # blocks whose (stripe, b) index vanished are rebuilt by the
        # codec's plan-grouped engine (one launch per lost block id across
        # all stripes) and re-placed co-location-safely.
        missing: list[tuple[int, int]] = []
        for sv in self._saved.values():
            for meta in sv.metas:
                for b in range(self.code.n):
                    if (meta.stripe_id, b) not in self.store._block_node:
                        missing.append((meta.stripe_id, b))
        return self.codec.rebuild_blocks(missing) if missing else 0

    def verify(self, step: int) -> bool:
        """Every stripe decodes to the stored payload length."""
        sv = self._saved.get(step)
        if sv is None:
            return False
        try:
            buf = self.codec.read_all(sv.metas)
        except NodeFailure:
            return False
        return len(buf) >= sv.manifest.total_bytes
