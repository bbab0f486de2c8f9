"""StripeCodec: the stripe *planner* — byte buffers <-> erasure-coded
stripes on a BlockStore, executed by the io-layer CodingEngine.

Implements the paper's basic operations (§4.1) over checkpoint bytes:

  write            — encode k data blocks -> n, place one-group-one-cluster
                     (UniLRC) / ECWide (baselines), round-robin node slots.
  normal_read      — read the k data blocks (maximum cluster parallelism,
                     Property 1).
  degraded_read    — any unavailable block served by XOR of its local group
                     (zero cross-cluster traffic for UniLRC, Property 2).
  reconstruct      — rebuild every block of a failed node from group
                     survivors and re-place (background re-protect).
  straggler_read   — group-local read that substitutes the slowest *data*
                     member with a parity-decode (first-r-of-(r+1)).

The codec plans — decides which blocks to read, recover, encode or patch —
and emits op descriptors to a `repro_torch.io.CodingEngine`, which batches
compatible ops into single backend calls. The backend is pluggable:
`backend=` takes a `Backend` instance or a registry name ("torch" for the
port's kernels — CUDA by default — or "numpy" for the byte-identical host
oracle); None means `TorchBackend("cuda")`.

Port of `repro.ckpt.stripe`: `StripeCodec` and the MTTDL-driven code
choice `choose_code`. Each public method submits
its ops and flushes the engine immediately; the two-phase `plan_*` methods
(submit ops, return a finish closure) let callers coalesce requests. Plans
come from the memoized layer in core.codec (plans_for /
decode_plan_cached), so the GF Gaussian elimination runs once per (code,
erasure pattern).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import numpy as np

from repro_torch.core.codes import Code, make_unilrc
from repro_torch.core.metrics import locality_metrics
from repro_torch.core.mttdl import MTTDLParams, code_mttdl_years
from repro_torch.core.placement import Placement, default_placement
from repro_torch.io.backend import Backend, resolve_backend
from repro_torch.io.engine import CodingEngine, OpHandle
from repro_torch.kernels import ops
from repro_torch.topo import Topology

from .store import BlockStore


@dataclasses.dataclass(frozen=True)
class StripeMeta:
    stripe_id: int
    nbytes: int          # payload bytes in this stripe (before padding)
    block_size: int


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """Accounting for one rebuild_blocks_report() call — the repair hook the
    failure simulator's scheduler consumes. `launches` comes from the
    kernel launch counters (one per plan group), so the scheduler can use
    it as a traffic oracle: launches == distinct decode plans exercised."""
    requested: int        # (stripe, block) pairs asked for
    placed: int           # pairs recovered AND re-placed on a live node
    launches: int         # batched kernel launches issued (0 on oracle path)
    inner_bytes: int      # block bytes read within the reader's cluster
    cross_bytes: int      # block bytes read across cluster gateways
    plan_groups: int = 0  # batched groups executed (fast + pattern groups)
    patterns: int = 0     # distinct multi-erasure patterns decoded
    multi_pairs: int = 0  # pairs recovered via the pattern-decode path
    aggregated_bytes: int = 0  # cross bytes shipped as gateway pre-folds

    @property
    def dropped(self) -> int:
        return self.requested - self.placed


@dataclasses.dataclass(frozen=True)
class RecoveryStats:
    """Grouping accounting from one recover_blocks() call: how the engine
    carved the request into batched launches."""
    fast_groups: int      # single-failure groups (one minimal plan each)
    pattern_groups: int   # multi-erasure groups (one DecodePlan each)
    fast_pairs: int       # pairs recovered via the minimal-plan fast path
    multi_pairs: int      # pairs recovered via the pattern-decode path

    @property
    def plan_groups(self) -> int:
        return self.fast_groups + self.pattern_groups


def _stats_from_handles(handles: dict[tuple[int, int], OpHandle]
                        ) -> RecoveryStats:
    """Per-request RecoveryStats, exact even when the engine flush
    coalesced other requests into the same batches: each resolved handle
    carries the (tier, group key) it rode."""
    fast_groups: set = set()
    pattern_groups: set = set()
    fast_pairs = multi_pairs = 0
    for h in handles.values():
        if not h.done or h._exc is not None:
            continue
        if h.tier == "fast":
            fast_pairs += 1
            fast_groups.add(h.group)
        elif h.tier == "pattern":
            multi_pairs += 1
            pattern_groups.add(h.group)
    return RecoveryStats(fast_groups=len(fast_groups),
                         pattern_groups=len(pattern_groups),
                         fast_pairs=fast_pairs, multi_pairs=multi_pairs)


class StripeCodec:
    """Encode/decode byte buffers as stripes of a given Code on a store.

    `backend` picks the execution tier — a `Backend` instance, a
    registry name ("torch"/"numpy"), or None for `TorchBackend("cuda")`.
    `max_batch_stripes` caps how many stripes ride one batched backend
    call: peak memory for encode is ~max_batch_stripes * n * block_size
    bytes (host staging + codeword array), so an unbounded batch over a
    checkpoint-scale buffer would OOM where the launch count barely
    changes. 64 stripes of 1 MiB blocks ≈ 13 GiB codeword ceiling for the
    widest paper code; launches stay at ceil(S/64) instead of S."""

    def __init__(self, code: Code, store: BlockStore, *,
                 block_size: int = 1 << 20,
                 placement: Placement | None = None,
                 backend: Backend | str | None = None,
                 max_batch_stripes: int = 64,
                 gateway_aggregation: bool = False):
        self.code = code
        self.store = store
        self.block_size = block_size
        self.placement = placement or default_placement(code)
        self.backend = resolve_backend(backend)
        self.engine = CodingEngine(code, store, self.backend,
                                   max_batch_stripes=max_batch_stripes,
                                   gateway_aggregation=gateway_aggregation)
        self.max_batch_stripes = max_batch_stripes
        if self.placement.num_clusters > store.topo.num_clusters:
            raise ValueError(
                f"{code.name} needs {self.placement.num_clusters} clusters; "
                f"topology has {store.topo.num_clusters}")
        # Slot assignment is `index-within-cluster + stripe_id (mod
        # nodes_per_cluster)`: if a cluster holds more stripe blocks than
        # it has nodes, two blocks of one local group silently share a node
        # and a single node failure becomes a multi-erasure — reject early.
        # The same pass records each block's (cluster, index-within-cluster)
        # so per-block placement is a lookup, not an O(n) scan.
        npc = store.topo.nodes_per_cluster
        self._block_slot: list[tuple[int, int]] = [(-1, -1)] * code.n
        for c in range(self.placement.num_clusters):
            members = self.placement.cluster_blocks(c)
            if len(members) > npc:
                raise ValueError(
                    f"{code.name} placement '{self.placement.name}' puts "
                    f"{len(members)} blocks of one stripe in cluster {c}, "
                    f"but the topology has only {npc} nodes per cluster — "
                    f"slot wraparound would co-locate local-group members "
                    f"on one node and break single-node fault tolerance")
            for idx, b in enumerate(members):
                self._block_slot[b] = (c, idx)
        self._stripes: dict[int, StripeMeta] = {}

    def clone(self) -> "StripeCodec":
        """A planner sharing THIS codec's code, store, placement, backend
        and stripe metadata, but owning a fresh `CodingEngine` queue.

        The shard unit of a sharded request front-end (the reference's
        `ShardedFrontend`; the port's comes with the serving slice): each
        shard plans and flushes on its own engine (so flushes overlap on a
        worker pool without sharing `_pending`), while every shard sees the same
        blocks and the same `_stripes` map (shared by reference — a write
        through any clone is visible to all)."""
        twin = object.__new__(StripeCodec)
        twin.code = self.code
        twin.store = self.store
        twin.block_size = self.block_size
        twin.placement = self.placement
        twin.backend = self.backend
        twin.max_batch_stripes = self.max_batch_stripes
        twin.engine = CodingEngine(
            self.code, self.store, self.backend,
            max_batch_stripes=self.max_batch_stripes,
            gateway_aggregation=self.engine.gateway_aggregation)
        twin._block_slot = self._block_slot
        twin._stripes = self._stripes
        return twin

    # -- encode / write ------------------------------------------------------
    def _node_for(self, stripe_id: int, block: int) -> int:
        # Rotate slots by stripe id so parity work spreads over nodes.
        cluster, idx = self._block_slot[block]
        return self.store.topo.node_of(cluster, idx + stripe_id)

    def _window_view(self, arr: np.ndarray, w0: int,
                     wn: int) -> np.ndarray:
        """(wn, k, block_size) view of stripes [w0, w0+wn) of the flat
        byte view `arr`. Zero-copy for every fully-covered window; only
        a window containing the buffer's padded tail is staged into an
        O(window) zeroed copy — never O(buffer)."""
        k, bs = self.code.k, self.block_size
        stripe_payload = k * bs
        a, b = w0 * stripe_payload, (w0 + wn) * stripe_payload
        if b <= arr.size:
            return arr[a:b].reshape(wn, k, bs)
        padded = np.zeros(wn * stripe_payload, dtype=np.uint8)
        padded[:arr.size - a] = arr[a:]
        return padded.reshape(wn, k, bs)

    def _record_meta(self, sid: int, stripe_index: int, total_bytes: int,
                     metas: list[StripeMeta]) -> None:
        stripe_payload = self.code.k * self.block_size
        nbytes = min(max(total_bytes - stripe_index * stripe_payload, 0),
                     stripe_payload)
        meta = StripeMeta(sid, nbytes, self.block_size)
        self._stripes[sid] = meta
        metas.append(meta)

    def write(self, buf: bytes, *, start_stripe: int = 0) -> list[StripeMeta]:
        """Stripe `buf` into ceil(len/k/bs) stripes starting at start_stripe.

        Stripes are encoded in batched engine launches of up to
        `max_batch_stripes` each (stripe-batch grid dimension) — one launch
        for typical writes, ceil(S/max_batch_stripes) for huge buffers —
        then placed block by block. Each window is a zero-copy
        `np.frombuffer` view of `buf` (only the padded tail window is
        staged), so per-batch extra memory is O(window).

        This is the synchronous reference path: encode the window, wait,
        place, repeat. `write_stream` produces byte-identical stripes
        with the encode+put pipeline overlapped."""
        k, bs = self.code.k, self.block_size
        stripe_payload = k * bs
        nstripes = max(1, math.ceil(len(buf) / stripe_payload))
        arr = np.frombuffer(buf, dtype=np.uint8)
        metas: list[StripeMeta] = []
        for batch_start in range(0, nstripes, self.max_batch_stripes):
            batch_n = min(self.max_batch_stripes, nstripes - batch_start)
            handle = self.engine.submit_encode(
                self._window_view(arr, batch_start, batch_n))
            self.engine.flush()
            codewords = handle.result()
            for i in range(batch_n):
                sid = start_stripe + batch_start + i
                for b in range(self.code.n):
                    self.store.put(sid, b, self._node_for(sid, b),
                                   codewords[i, b].tobytes())
                self._record_meta(sid, batch_start + i, len(buf), metas)
        return metas

    def write_stream(self, buf: bytes, *, start_stripe: int = 0,
                     window_stripes: int | None = None) -> list[StripeMeta]:
        """Checkpoint-scale write fast path: same stripes, bytes and
        placement as `write` (byte-identity is property-tested on both
        backends), but fused and pipelined:

          * zero-copy ingest — every window is a reshaped `np.frombuffer`
            view of `buf`; only the final padded tail is staged;
          * double-buffered encode — window w+1's kernel launch is
            dispatched before window w's codewords are forced
            (`CodingEngine.encode_stream`), so device compute overlaps
            the host landing path;
          * bulk landing — each window's S_w * n blocks ride ONE
            `BlockStore.put_many` with a single batched mutation
            notification, not S_w * n `put` round-trips.

        Peak extra memory is O(window): at most two windows of codewords
        (the double buffer) plus one padded tail window are ever live.
        `window_stripes` (default `max_batch_stripes`, clamped to it)
        trades pipeline depth against staging memory — see
        `kernels.autotune.plan_stream_windows`."""
        k, bs = self.code.k, self.block_size
        stripe_payload = k * bs
        nstripes = max(1, math.ceil(len(buf) / stripe_payload))
        arr = np.frombuffer(buf, dtype=np.uint8)
        window = min(window_stripes or self.max_batch_stripes,
                     self.max_batch_stripes)
        window = max(1, window)
        starts = list(range(0, nstripes, window))
        metas: list[StripeMeta] = []

        def windows():
            for w0 in starts:
                yield self._window_view(arr, w0, min(window, nstripes - w0))

        def land(idx: int, codewords: np.ndarray) -> None:
            w0 = starts[idx]
            entries = []
            for i in range(codewords.shape[0]):
                sid = start_stripe + w0 + i
                for b in range(self.code.n):
                    entries.append((sid, b, self._node_for(sid, b),
                                    codewords[i, b]))
            self.store.put_many(entries)
            for i in range(codewords.shape[0]):
                self._record_meta(start_stripe + w0 + i, w0 + i,
                                  len(buf), metas)

        self.engine.encode_stream(windows(), land)
        return metas

    # -- read planners -------------------------------------------------------
    def _submit_stripe_read(self, sid: int, blocks: range | list[int],
                            reader_cluster: int | None
                            ) -> dict[int, OpHandle]:
        """Read ops for available blocks, recover ops for the rest."""
        return {
            b: (self.engine.submit_read(sid, b,
                                        reader_cluster=reader_cluster)
                if self.store.available(sid, b) else
                self.engine.submit_recover(sid, b,
                                           reader_cluster=reader_cluster))
            for b in blocks}

    def plan_normal_read(self, meta: StripeMeta, *,
                         reader_cluster: int | None = None
                         ) -> Callable[[], bytes]:
        """Two-phase normal_read: submit ops now, assemble at finish."""
        handles = self._submit_stripe_read(
            meta.stripe_id, range(self.code.k), reader_cluster)

        def finish() -> bytes:
            out = b"".join(handles[b].result()
                           for b in range(self.code.k))
            return out[:meta.nbytes]
        return finish

    def plan_degraded_read(self, meta: StripeMeta, block: int, *,
                           reader_cluster: int | None = None
                           ) -> Callable[[], bytes]:
        handle = self.engine.submit_recover(meta.stripe_id, block,
                                            reader_cluster=reader_cluster)
        return handle.result

    def plan_recover_blocks(self, pairs: list[tuple[int, int]], *,
                            reader_cluster: int | None = None,
                            strict: bool = True
                            ) -> Callable[[], tuple[dict, RecoveryStats]]:
        handles = {
            p: self.engine.submit_recover(p[0], p[1],
                                          reader_cluster=reader_cluster,
                                          strict=strict)
            for p in dict.fromkeys(pairs)}

        def finish():
            out = {}
            for p, h in handles.items():
                data = h.result()
                if data is not None:      # None == dropped (strict=False)
                    out[p] = data
            return out, _stats_from_handles(handles)
        return finish

    # -- reads ---------------------------------------------------------------
    def normal_read(self, meta: StripeMeta, *,
                    reader_cluster: int | None = None) -> bytes:
        """Read the k data blocks; unavailable ones are recovered in the
        same engine flush — one launch per erasure pattern / fast group,
        not one decode per missing block."""
        finish = self.plan_normal_read(meta, reader_cluster=reader_cluster)
        self.engine.flush()
        return finish()

    def degraded_read(self, meta: StripeMeta, block: int, *,
                      reader_cluster: int | None = None) -> bytes:
        """Recover one unavailable block from survivors via the engine.

        Fast path: the minimal single-failure plan (group-local, XOR-only
        for UniLRC). If plan sources are also unavailable, the engine
        decodes the stripe's full live erasure pattern.
        """
        finish = self.plan_degraded_read(meta, block,
                                         reader_cluster=reader_cluster)
        self.engine.flush()
        return finish()

    def straggler_read(self, meta: StripeMeta, group_idx: int, *,
                       reader_cluster: int | None = None
                       ) -> dict[int, bytes]:
        """Read a local group's data blocks, substituting the slowest
        *data* member (per simulated node latency) with a parity-decode —
        the 'first r of r+1' straggler mitigation UniLRC's uniform groups
        allow. Returns {block_id: bytes} for the group's data blocks.

        The candidate set is the data members only: the direct read never
        touches the group parity, so its latency cannot make it the
        straggler. (Regression: the old code took the max over the WHOLE
        group, and a slow parity node silently masked a slow data member
        — no substitution happened at all.) Note the policy mitigates
        *data-path* stragglers: the substitute decode does source the
        parity, so when the parity node is itself the slowest in the
        group the decode leg waits on it — in a real deployment that
        read is issued speculatively alongside the direct ones
        (first-r-of-(r+1)), so the simulated substitution is the
        pessimistic bound, not an extra round trip."""
        sid = meta.stripe_id
        data_members = [b for b in self.code.groups[group_idx]
                        if self.code.block_type[b] == 'd']
        lat = {b: self.store.latency_of(sid, b) for b in data_members}
        slowest = max(data_members, key=lambda b: lat[b])
        substitute = lat[slowest] > 0
        direct = [b for b in data_members
                  if b != slowest or not substitute]
        got = self.store.get_many([(sid, b) for b in direct],
                                  reader_cluster=reader_cluster)
        out = {}
        for b in data_members:
            if b == slowest and substitute:
                out[b] = self.degraded_read(meta, b,
                                            reader_cluster=reader_cluster)
            else:
                out[b] = got[(sid, b)]
        return out

    # -- partial update (delta parity) ----------------------------------------
    def update_block(self, meta: StripeMeta, block: int, new_data: bytes,
                     *, reader_cluster: int | None = None) -> int:
        """Overwrite one data block and patch every parity in place via the
        code's GF(2^8) linearity:  p_new = p_old ⊕ A[:, block]·Δ  with
        Δ = old ⊕ new — the partial-update property the paper's related
        work (CoRD [38]) builds on. Training-state deltas between
        checkpoints touch a fraction of blocks; this writes O(Δ·(n−k)/k)
        bytes instead of re-encoding the stripe. The engine stages ALL
        reads (old data + every touched parity) before the first write,
        so a NodeFailure anywhere aborts with the stripe untouched; the
        delta terms of every update in a flush ride ONE GF matmul.
        Returns parity blocks touched."""
        assert self.code.block_type[block] == 'd', "update data blocks only"
        handle = self.engine.submit_update(meta.stripe_id, block, new_data,
                                           reader_cluster=reader_cluster)
        self.engine.flush()
        return handle.result()

    # -- batched recovery engine --------------------------------------------
    def recover_blocks(self, pairs: list[tuple[int, int]], *,
                       reader_cluster: int | None = None,
                       strict: bool = True
                       ) -> dict[tuple[int, int], bytes]:
        """Recover many (stripe, block) pairs: the pattern-grouped engine.

        Two tiers, both batched over stripes (see repro_torch.io.engine):

        * fast path — a requested block whose minimal single-failure plan
          has no failed source. Grouped by block id; one `recover_many`
          launch per group (XOR-fold for UniLRC's XOR-only plans,
          group-local traffic — Property 2 is preserved even when
          unrelated blocks of the stripe are down).
        * pattern path — everything else. Each stripe's live erasure
          pattern is computed ONCE, stripes are grouped by pattern —
          `decode_plan_cached` returns the identical DecodePlan per
          (code, pattern) — and each group rides ONE `apply_decode_many`
          launch. Correlated failures over S stripes cost O(#distinct
          patterns) launches, not O(S).

        Groups larger than `max_batch_stripes` are chunked. With
        strict=False an unrecoverable pair (pattern beyond the code's
        tolerance) is omitted from the result instead of aborting the
        whole batch (reads must raise; repair heals everything it can)."""
        out, _ = self._recover_blocks(pairs, reader_cluster=reader_cluster,
                                      strict=strict)
        return out

    def _recover_blocks(self, pairs: list[tuple[int, int]], *,
                        reader_cluster: int | None = None,
                        strict: bool = True
                        ) -> tuple[dict[tuple[int, int], bytes],
                                   RecoveryStats]:
        """recover_blocks plus grouping stats (see RecoveryStats)."""
        finish = self.plan_recover_blocks(pairs,
                                          reader_cluster=reader_cluster,
                                          strict=strict)
        self.engine.flush()
        return finish()

    # -- reconstruction ------------------------------------------------------
    def _pick_rebuild_node(self, sid: int, block: int,
                           occupied: set[int], exclude: int) -> int | None:
        """Live node of `block`'s home cluster holding no other block of
        stripe `sid` (preserving the single-node fault-tolerance invariant
        the constructor validates); falls back to a live co-located node
        only when the cluster has no free node left, and None only when
        the whole cluster is down."""
        cluster = self.placement.assignment[block]
        fallback = None
        for slot in range(self.store.topo.nodes_per_cluster):
            cand = self.store.topo.node_of(cluster, slot)
            if cand in self.store.failed_nodes or cand == exclude:
                continue
            if cand in occupied:
                if fallback is None:
                    fallback = cand
                continue
            return cand
        return fallback

    def plan_rebuild(self, pairs: list[tuple[int, int]], *,
                     reader_cluster: int | None = None,
                     exclude_node: int = -1
                     ) -> Callable[[], tuple[int, RecoveryStats]]:
        """Two-phase rebuild: recovery ops now, placement at finish.
        The finish closure returns (#blocks placed, RecoveryStats)."""
        pairs = list(dict.fromkeys(pairs))   # duplicates would double-place
        handles = {
            p: self.engine.submit_recover(p[0], p[1],
                                          reader_cluster=reader_cluster,
                                          strict=False)
            for p in pairs}

        def finish() -> tuple[int, RecoveryStats]:
            occupied = self.store.nodes_holding_many(
                {sid for sid, _b in pairs})
            placed = 0
            for (sid, b) in pairs:
                data = handles[(sid, b)].result()
                if data is None:             # unrecoverable right now
                    continue
                occ = occupied[sid]
                cand = self._pick_rebuild_node(sid, b, occ, exclude_node)
                if cand is None:
                    continue
                self.store.put(sid, b, cand, data)
                occ.add(cand)
                placed += 1
            return placed, _stats_from_handles(handles)
        return finish

    def rebuild_blocks(self, pairs: list[tuple[int, int]], *,
                       reader_cluster: int | None = None,
                       exclude_node: int = -1) -> int:
        """Recover lost (stripe, block) pairs with the batched plan-grouped
        engine and re-place each on a live node of its home cluster.
        Returns #blocks placed; a pair is dropped (not fatal) when its
        entire cluster is down or its stripe's erasure pattern is currently
        beyond the code's tolerance — repair heals everything it can."""
        return self.rebuild_blocks_report(
            pairs, reader_cluster=reader_cluster,
            exclude_node=exclude_node).placed

    def rebuild_blocks_report(self, pairs: list[tuple[int, int]], *,
                              reader_cluster: int | None = None,
                              exclude_node: int = -1) -> RepairReport:
        """rebuild_blocks plus launch/traffic accounting (RepairReport).

        The reference's failure simulator runs its data-path repairs
        through this hook: the launch delta
        tells it how many plan groups actually hit the kernels, and the
        store's inner/cross byte deltas feed the cross-cluster
        repair-traffic report."""
        requested = len(dict.fromkeys(pairs))
        launches0 = ops.kernel_launch_snapshot()
        t = self.store.traffic
        inner0, cross0 = t.inner_bytes, t.cross_bytes
        agg0 = t.aggregated_bytes
        finish = self.plan_rebuild(pairs, reader_cluster=reader_cluster,
                                   exclude_node=exclude_node)
        self.engine.flush()
        placed, stats = finish()
        return RepairReport(
            requested=requested, placed=placed,
            launches=ops.launches_since(launches0),
            inner_bytes=t.inner_bytes - inner0,
            cross_bytes=t.cross_bytes - cross0,
            plan_groups=stats.plan_groups, patterns=stats.pattern_groups,
            multi_pairs=stats.multi_pairs,
            aggregated_bytes=t.aggregated_bytes - agg0)

    def reconstruct_node(self, node: int) -> int:
        """Rebuild every block the failed node held, re-placing each on a
        free node of its home cluster. Returns #blocks rebuilt.

        Lost blocks are grouped by recovery plan and rebuilt with one
        batched kernel launch per group — a failed node holds one block per
        stripe, so healing S stripes costs #distinct-blocks launches, not
        S."""
        lost = self.store.blocks_on_node(node)
        cluster = self.store.topo.cluster_of(node)
        return self.rebuild_blocks(lost, reader_cluster=cluster,
                                   exclude_node=node)

    def plan_read_all(self, metas: list[StripeMeta], *,
                      reader_cluster: int | None = None
                      ) -> Callable[[], bytes]:
        handles = {
            meta.stripe_id: self._submit_stripe_read(
                meta.stripe_id, range(self.code.k), reader_cluster)
            for meta in metas}

        def finish() -> bytes:
            parts = []
            for meta in metas:
                hs = handles[meta.stripe_id]
                buf = b"".join(hs[b].result()
                               for b in range(self.code.k))
                parts.append(buf[:meta.nbytes])
            return b"".join(parts)
        return finish

    def read_all(self, metas: list[StripeMeta], *,
                 reader_cluster: int | None = None) -> bytes:
        """Read every stripe's data blocks; unavailable blocks across all
        stripes are recovered by the pattern-grouped engine rather than
        one kernel launch per stripe."""
        finish = self.plan_read_all(metas, reader_cluster=reader_cluster)
        self.engine.flush()
        return finish()


def choose_code(topo: Topology, *, target_rate: float = 0.85,
                min_mttdl_years: float = 1e9,
                params: MTTDLParams | None = None) -> Code:
    """Pick UniLRC(α, z=num_clusters) meeting a storage-efficiency target,
    MTTDL-checked (the reference's 'MTTDL-driven code choice' knob).

    rate = 1 - (α+1)/(αz+1) grows with α; pick the smallest α whose rate
    reaches the target (smaller α = smaller groups = cheaper recovery),
    then verify MTTDL.
    """
    params = params or MTTDLParams()
    z = topo.num_clusters
    if z < 2:
        raise ValueError("need >= 2 clusters for UniLRC")
    for alpha in range(1, 9):
        rate = 1 - (alpha + 1) / (alpha * z + 1)
        code = make_unilrc(alpha, z)
        if code.n > topo.num_nodes:
            # cannot give each block its own node; stop growing stripes
            break
        if rate >= target_rate:
            m = locality_metrics(code, default_placement(code))
            if code_mttdl_years(code, m, params) >= min_mttdl_years:
                return code
    # Fall back: widest feasible alpha, rate be damned — the old
    # max(1, ...) clamp could hand a tiny topology a stripe wider than
    # its node count. Feasible means each local group (alpha*zz + 1
    # blocks, one cluster each) fits nodes_per_cluster — the bound
    # StripeCodec's constructor enforces, and exactly n <= num_nodes
    # when zz == num_clusters. If even alpha=1 does not fit, shrink the
    # cluster span until some UniLRC does.
    for zz in range(z, 1, -1):
        alpha = min(8, (topo.nodes_per_cluster - 1) // zz)
        if alpha >= 1:
            return make_unilrc(alpha, zz)
    raise ValueError(
        f"no UniLRC fits a {topo.num_clusters}x{topo.nodes_per_cluster} "
        f"topology; the smallest stripe, UniLRC(1, 2), needs 3-node "
        f"clusters")
