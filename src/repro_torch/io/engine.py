"""CodingEngine: an op queue with cross-request batched execution.

Port of `repro.io.engine.CodingEngine`. Callers (the `StripeCodec`
planner) submit op descriptors — read, decode-pattern recovery, encode,
delta-update — and get back an `OpHandle`. Nothing executes until
`flush()`, which groups *all* pending ops, across independent requests,
into the fewest batched backend calls:

  * reads     — one `BlockStore.get_many` batch per reader cluster
                (one failure-set check + one TrafficStats pass each);
  * recovers  — the pattern-grouped recovery engine: per stripe ONE
                availability scan, fast single-failure groups keyed by
                block id (one `recover_many` launch each), everything
                else keyed by cached DecodePlan identity (one
                `apply_decode_many` launch per live erasure pattern).
                Ten concurrent degraded reads sharing a pattern cost one
                launch, not ten — the cross-request coalescing the
                paper's frequent-concurrent-events regime needs;
  * encodes   — pending (S_i, k, B) payloads are concatenated and
                chunked by `max_batch_stripes`: many small writes ride
                one `encode_many` launch;
  * updates   — delta-parity updates are staged (ALL reads before ANY
                write, preserving the stripe-intact-on-failure
                invariant) and their GF delta terms ride ONE matmul per
                conflict-free wave via a block-structured coefficient
                matrix.

Checkpoint-scale writes bypass the queue through `encode_stream`: a
double-buffered window pipeline (dispatch window w+1's encode lazily,
force + land window w) whose peak memory is O(window) and whose launch
count is ceil(S / max_batch_stripes) — the fused encode+put fast path
`StripeCodec.write_stream` rides. Windows are forced through
`Backend.force`, so a device backend lands them from pinned buffers.

Execution order within one flush is reads/recovers/encodes first,
mutating updates last; two updates touching the same stripe go in
separate waves, executed in submission order. Errors are per *group*:
a failed batch (NodeFailure, undecodable pattern) marks only its member
ops failed — `OpHandle.result()` re-raises — and the rest of the flush
proceeds, so one doomed request cannot poison a coalesced batch.

The engine is deliberately ignorant of placement and stripe metadata:
it executes byte math and store I/O. Deciding *which* ops realize a
request (read vs recover, which blocks, where rebuilt blocks land) is
the planner's job in `ckpt/stripe.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.analysis.hazards import analyze_flush
from repro_torch.core.codec import decode_plan_cached, plans_for
from repro_torch.core.codes import Code
from repro_torch.kernels import ops as kernel_ops
from repro_torch.topo import plan_is_xor_linear

from .backend import Backend


class OpHandle:
    """Future-like result of one submitted op: resolved at flush()."""

    __slots__ = ("_done", "_value", "_exc", "tier", "group")

    def __init__(self) -> None:
        self._done = False
        self._value: Any = None
        self._exc: BaseException | None = None
        self.tier: str | None = None   # recovers: 'fast' | 'pattern'
        self.group: tuple[str, Any] | None = None
        #             recovers: the batch group key this op rode —
        #                      ('fast', block id) or ('pattern', pattern) —
        #                      so planners can attribute per-request stats
        #                      even when a flush coalesced many requests

    @property
    def done(self) -> bool:
        return self._done

    def _set(self, value: Any) -> None:
        self._done, self._value = True, value

    def _fail(self, exc: BaseException) -> None:
        self._done, self._exc = True, exc

    def result(self) -> Any:
        if not self._done:
            raise RuntimeError("op not flushed yet — call engine.flush()")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclasses.dataclass(eq=False)        # identity hash: ops key batch maps
class _Op:
    kind: str                    # 'read' | 'recover' | 'encode' | 'update'
    handle: OpHandle
    stripe: int = -1
    block: int = -1
    reader_cluster: int | None = None
    strict: bool = True          # recover: raise (True) vs drop to None
    data: np.ndarray | None = None        # encode: (S, k, B)
    new_data: bytes | None = None         # update payload


@dataclasses.dataclass
class FlushStats:
    """How one flush carved the pending ops into batched backend calls."""
    ops: int = 0
    read_batches: int = 0
    encode_batches: int = 0
    fast_groups: int = 0       # single-failure block-id groups
    pattern_groups: int = 0    # distinct multi-erasure patterns decoded
    fast_pairs: int = 0
    multi_pairs: int = 0
    dropped_pairs: int = 0     # non-strict recovers beyond tolerance
    update_waves: int = 0
    gateway_folds: int = 0     # remote-cluster pre-fold launches issued
    aggregated_pairs: int = 0  # pairs served via >= one gateway pre-fold
    launches: int = 0          # kernel launches issued BY this flush
    inner_bytes: int = 0       # store bytes this flush moved, inner tier
    cross_bytes: int = 0       # ... across cluster gateways
    aggregated_bytes: int = 0  # of cross_bytes: gateway pre-folded

    @property
    def plan_groups(self) -> int:
        return self.fast_groups + self.pattern_groups


class CodingEngine:
    """Queue + batched executor over one (code, store, backend) triple.

    `max_batch_stripes` bounds stripes per backend call exactly like the
    pre-refactor StripeCodec bound its launches (peak staging memory ~
    max_batch_stripes * n * block_size bytes)."""

    def __init__(self, code: Code, store: Any, backend: Backend, *,
                 max_batch_stripes: int = 64,
                 gateway_aggregation: bool = False):
        if max_batch_stripes < 1:
            raise ValueError("max_batch_stripes must be >= 1")
        self.code = code
        self.store = store
        self.backend = backend
        self.max_batch_stripes = max_batch_stripes
        # Gateway XOR aggregation (paper §3.3): when a recovery plan is
        # XOR-linear and the reader cluster is known, each remote cluster
        # pre-folds its source blocks at its gateway and ships ONE block.
        # Off by default — it changes launch counts and cross-byte
        # accounting, so callers opt in (the topology benchmark, the
        # degraded-read serving path).
        self.gateway_aggregation = gateway_aggregation
        self._pending: list[_Op] = []

    # -- submission ----------------------------------------------------------
    def _submit(self, op: _Op) -> OpHandle:
        self._pending.append(op)
        return op.handle

    def submit_read(self, stripe: int, block: int, *,
                    reader_cluster: int | None = None) -> OpHandle:
        """Plain block read; result is bytes."""
        return self._submit(_Op("read", OpHandle(), stripe, block,
                                reader_cluster))

    def submit_recover(self, stripe: int, block: int, *,
                       reader_cluster: int | None = None,
                       strict: bool = True) -> OpHandle:
        """Recover one unavailable block; result is bytes, or None when
        strict=False and the stripe's pattern is beyond tolerance."""
        return self._submit(_Op("recover", OpHandle(), stripe, block,
                                reader_cluster, strict))

    def submit_encode(self, data: np.ndarray) -> OpHandle:
        """Encode (S, k, B) uint8 payload; result is (S, n, B) codewords."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 3:
            raise ValueError(f"encode expects (S, k, B), got {data.shape}")
        if data.shape[0] == 0:
            # a zero-stripe op would yield no chunk rows and blow up in
            # the result stack AFTER _pending is cleared, stranding every
            # co-flushed handle — reject at submit time instead
            raise ValueError("encode needs at least one stripe")
        op = _Op("encode", OpHandle())
        op.data = data
        return self._submit(op)

    def submit_update(self, stripe: int, block: int, new_data: bytes, *,
                      reader_cluster: int | None = None) -> OpHandle:
        """Delta-parity partial update of one data block; result is the
        number of parity blocks patched."""
        op = _Op("update", OpHandle(), stripe, block, reader_cluster)
        op.new_data = bytes(new_data)
        return self._submit(op)

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- flush ---------------------------------------------------------------
    def flush(self, *, analyze: bool = False) -> FlushStats:
        if analyze:
            # Debug mode: statically prove the queued schedule hazard-free
            # (waves conflict-free, all-reads-before-any-write, submission
            # order preserved) BEFORE executing anything. Raises
            # HazardViolation with the offending op pair.
            analyze_flush(self, raise_on_violation=True)
        ops_list, self._pending = self._pending, []
        stats = FlushStats(ops=len(ops_list))
        by_kind: dict[str, list[_Op]] = {}
        for op in ops_list:
            by_kind.setdefault(op.kind, []).append(op)
        # Thread-local attribution scopes: the launch/traffic totals on
        # FlushStats stay exact when several shard engines flush
        # concurrently (a global before/after snapshot would fold the
        # other shards' work into this flush's numbers).
        with kernel_ops.launch_scope() as scope, \
                self.store.traffic.scoped() as tdelta:
            self._run_encodes(by_kind.get("encode", []), stats)
            self._run_reads(by_kind.get("read", []), stats)
            self._run_recovers(by_kind.get("recover", []), stats)
            self._run_updates(by_kind.get("update", []), stats)
        stats.launches = scope.total
        stats.inner_bytes = tdelta.inner_bytes
        stats.cross_bytes = tdelta.cross_bytes
        stats.aggregated_bytes = tdelta.aggregated_bytes
        return stats

    # -- reads ---------------------------------------------------------------
    def _run_reads(self, ops_list: list[_Op], stats: FlushStats) -> None:
        by_rc: dict[int | None, list[_Op]] = {}
        for op in ops_list:
            by_rc.setdefault(op.reader_cluster, []).append(op)
        for rc, group in sorted(by_rc.items(),
                                key=lambda kv: (kv[0] is None, kv[0] or 0)):
            pairs = list(dict.fromkeys((op.stripe, op.block)
                                       for op in group))
            try:
                got = self.store.get_many(pairs, reader_cluster=rc)
            except Exception:
                # A bad pair fails the whole batched check before any
                # traffic is recorded; retry per op so only the ops that
                # actually touch the failed/missing block error out.
                for op in group:
                    try:
                        op.handle._set(self.store.get(
                            op.stripe, op.block, reader_cluster=rc))
                    except Exception as exc:
                        op.handle._fail(exc)
                continue
            stats.read_batches += 1
            for op in group:
                op.handle._set(got[(op.stripe, op.block)])

    # -- recovers (the pattern-grouped engine) -------------------------------
    def _gather_sources(self, sids: list[int], sources: tuple[int, ...],
                        rc: int | None) -> dict[int, np.ndarray]:
        """{source block id: (S, B)} for a plan group, read via ONE
        get_many batch."""
        got = self.store.get_many(
            [(sid, s) for sid in sids for s in sources], reader_cluster=rc)
        return {s: np.stack([np.frombuffer(got[(sid, s)], np.uint8)
                             for sid in sids]) for s in sources}

    def _should_aggregate(self, rc: int | None, plan) -> bool:
        return (self.gateway_aggregation and rc is not None
                and plan_is_xor_linear(plan))

    def _source_clusters(self, sid: int, sources) -> tuple[int, ...]:
        """Where each source block of `sid` physically lives right now —
        rebuilt blocks may sit on fallback nodes, so ask the store, not
        the placement."""
        topo = self.store.topo
        return tuple(topo.cluster_of(self.store.node_of(sid, s))
                     for s in sources)

    def _recover_xor_batch(self, sids: list[int], sources: tuple[int, ...],
                           rc: int | None, stats: FlushStats
                           ) -> np.ndarray:
        """Gateway-aggregated execution of one XOR-linear plan over a
        stripe batch: remote clusters holding >= 2 sources read them
        locally (inner-tier bytes at THEIR gateway), fold them with one
        `xor_fold_many` launch, and ship one pre-folded block per
        stripe (cross-tier `aggregated_bytes`); the reader folds the
        partials with its own local + singleton-remote sources. XOR
        associativity makes the result byte-identical to the direct
        fold of all sources, on either backend."""
        groups: dict[tuple[int, ...], list[int]] = {}
        for i, sid in enumerate(sids):
            sig = self._source_clusters(sid, sources)
            groups.setdefault(sig, []).append(i)
        results: list[np.ndarray | None] = [None] * len(sids)
        for sig, poss in sorted(groups.items()):
            gsids = [sids[i] for i in poss]
            by_c: dict[int, list[int]] = {}
            for s, c in zip(sources, sig):
                by_c.setdefault(c, []).append(s)
            direct = [s for c, ss in sorted(by_c.items())
                      if c == rc or len(ss) == 1 for s in ss]
            folds = {c: ss for c, ss in by_c.items()
                     if c != rc and len(ss) > 1}
            parts: list[np.ndarray] = []
            if direct:
                got = self._gather_sources(gsids, tuple(direct), rc)
                parts += [got[s] for s in direct]
            for c, ss in sorted(folds.items()):
                got = self._gather_sources(gsids, tuple(ss), c)
                partial = self.backend.xor_fold_many(
                    np.stack([got[s] for s in ss], axis=1))
                stats.gateway_folds += 1
                self.store.traffic.add_shipped(int(partial.nbytes))
                parts.append(partial)
            rec = self.backend.xor_fold_many(np.stack(parts, axis=1))
            if folds:
                stats.aggregated_pairs += len(gsids)
            for i, row in zip(poss, rec):
                results[i] = row
        return np.stack(results)

    def _run_recovers(self, ops_list: list[_Op], stats: FlushStats) -> None:
        by_rc: dict[int | None, list[_Op]] = {}
        for op in ops_list:
            by_rc.setdefault(op.reader_cluster, []).append(op)
        for rc, group in sorted(by_rc.items(),
                                key=lambda kv: (kv[0] is None, kv[0] or 0)):
            self._recover_cluster_group(rc, group, stats)

    def _recover_cluster_group(self, rc: int | None, group: list[_Op],
                               stats: FlushStats) -> None:
        pair_ops: dict[tuple[int, int], list[_Op]] = {}
        by_stripe: dict[int, list[int]] = {}
        for op in group:
            key = (op.stripe, op.block)
            if key not in pair_ops:
                by_stripe.setdefault(op.stripe, []).append(op.block)
            pair_ops.setdefault(key, []).append(op)
        plans = plans_for(self.code)
        n = self.code.n
        fast: dict[int, list[int]] = {}      # block id -> [stripe ids]
        # pattern -> [(stripe id, requested blocks under that pattern)]
        slow: dict[tuple[int, ...], list[tuple[int, list[int]]]] = {}
        for sid in sorted(by_stripe):
            eset = {b for b in range(n)
                    if not self.store.available(sid, b)}
            slow_blocks = []
            for b in by_stripe[sid]:
                if eset.intersection(plans[b].sources):
                    slow_blocks.append(b)
                else:
                    fast.setdefault(b, []).append(sid)
            if slow_blocks:
                pattern = tuple(sorted(eset.union(slow_blocks)))
                slow.setdefault(pattern, []).append((sid, slow_blocks))

        def resolve(sid: int, b: int, data: bytes, tier: str,
                    group) -> None:
            for op in pair_ops[(sid, b)]:
                op.handle.tier = tier
                op.handle.group = group
                op.handle._set(data)

        def fail_pairs(keys: list[tuple[int, int]],
                       exc: BaseException) -> None:
            for key in keys:
                for op in pair_ops[key]:
                    op.handle._fail(exc)

        for b, sids in sorted(fast.items()):
            plan = plans[b]
            stats.fast_groups += 1
            aggregate = self._should_aggregate(rc, plan)
            for i0 in range(0, len(sids), self.max_batch_stripes):
                batch = sids[i0:i0 + self.max_batch_stripes]
                try:
                    if aggregate:
                        rec = self._recover_xor_batch(batch, plan.sources,
                                                      rc, stats)
                    else:
                        stacked = self._gather_sources(batch, plan.sources,
                                                       rc)
                        rec = self.backend.recover_many(plan, stacked)
                except Exception as exc:
                    fail_pairs([(sid, b) for sid in batch], exc)
                    continue
                for i, sid in enumerate(batch):
                    resolve(sid, b, rec[i].tobytes(), "fast", ("fast", b))
                    stats.fast_pairs += 1

        for pattern, entries in sorted(slow.items()):
            keys = [(sid, b) for sid, blocks in entries for b in blocks]
            try:
                dplan = decode_plan_cached(self.code, pattern)
            except ValueError as exc:   # beyond the code's tolerance now
                for key in keys:
                    for op in pair_ops[key]:
                        if op.strict:
                            op.handle._fail(exc)
                        else:
                            op.handle._set(None)
                            stats.dropped_pairs += 1
                continue
            stats.pattern_groups += 1
            # Every member stripe's erased set is a subset of `pattern`,
            # so the plan's sources are alive for the whole group. (No
            # gateway pre-fold here: a pattern group always decodes >= 2
            # erased blocks, which fails the single-target XOR-linearity
            # check a plain-XOR gateway needs.)
            for i0 in range(0, len(entries), self.max_batch_stripes):
                chunk = entries[i0:i0 + self.max_batch_stripes]
                sids = [sid for sid, _ in chunk]
                try:
                    stacked = self._gather_sources(sids, dplan.sources, rc)
                    rec = self.backend.apply_decode_many(dplan, stacked)
                except Exception as exc:
                    fail_pairs([(sid, b) for sid, blocks in chunk
                                for b in blocks], exc)
                    continue
                for i, (sid, blocks) in enumerate(chunk):
                    for b in blocks:
                        resolve(sid, b, rec[b][i].tobytes(), "pattern",
                                ("pattern", pattern))
                        stats.multi_pairs += 1

    # -- encodes -------------------------------------------------------------
    def _run_encodes(self, ops_list: list[_Op], stats: FlushStats) -> None:
        by_shape: dict[tuple[int, int], list[_Op]] = {}
        for op in ops_list:
            by_shape.setdefault(op.data.shape[1:], []).append(op)
        for _shape, group in sorted(by_shape.items()):
            # Flatten every pending payload's stripes into one row list,
            # then chunk: many small writes coalesce into one launch.
            rows = [(op, i) for op in group for i in range(len(op.data))]
            outs = {id(op): [] for op in group}
            for i0 in range(0, len(rows), self.max_batch_stripes):
                chunk = rows[i0:i0 + self.max_batch_stripes]
                op0, first = chunk[0]
                # Rows of one op are consecutive by construction, so a
                # single-op chunk is a contiguous slice of its payload:
                # hand the backend a VIEW instead of np.stack's copy —
                # on the checkpoint write path that copy was O(window)
                # per chunk for nothing.
                whole = all(op is op0 for op, _ in chunk)
                data = (op0.data[first:first + len(chunk)] if whole
                        else np.stack([op.data[i] for op, i in chunk]))
                try:
                    cw = self.backend.encode_many(self.code, data)
                except Exception as exc:
                    for op in dict.fromkeys(op for op, _ in chunk):
                        if not op.handle.done:
                            op.handle._fail(exc)
                    continue
                stats.encode_batches += 1
                if whole and len(chunk) == len(op0.data):
                    op0.handle._set(cw)     # one chunk == the whole op
                    continue
                for j, (op, _i) in enumerate(chunk):
                    outs[id(op)].append(cw[j])
            for op in group:
                if not op.handle.done:
                    op.handle._set(np.stack(outs[id(op)]))

    # -- streaming encode (checkpoint write fast path) -----------------------
    def encode_stream(self, windows, sink) -> int:
        """Double-buffered streaming encode: the checkpoint-scale write
        path, fused with store landing.

        `windows` yields (S_w, k, B) uint8 arrays (views are fine —
        nothing is copied here), each with S_w <= max_batch_stripes;
        `sink(index, codewords)` receives every window's forced (S_w,
        n, B) result, in order. The pipeline overlap: window w+1's
        encode is DISPATCHED (`Backend.encode_many_lazy` — a CUDA
        launch and its copy into a pinned landing buffer on the torch
        backend) before window w's result is forced
        (`Backend.force`) and handed to the sink, so device compute runs while the
        host lands blocks. At most two windows of codewords are live at
        once — peak memory is O(window), not O(buffer) — and each
        window is exactly one backend call, so a buffer of S stripes
        costs ceil(S / window) launches, same as the queued path.

        This bypasses the op queue (no coalescing with pending ops —
        callers sequence it like any other store mutation); launches
        and traffic still ride the thread-local attribution scopes.
        Returns the number of windows encoded."""
        served = 0
        prev: tuple[int, Any] | None = None
        with kernel_ops.launch_scope(), self.store.traffic.scoped():
            for view in windows:
                data = np.ascontiguousarray(view, dtype=np.uint8)
                if data.ndim != 3 or data.shape[1] != self.code.k:
                    raise ValueError(
                        f"encode_stream expects (S, k={self.code.k}, B) "
                        f"windows, got {data.shape}")
                if not 1 <= data.shape[0] <= self.max_batch_stripes:
                    raise ValueError(
                        f"window of {data.shape[0]} stripes outside "
                        f"[1, max_batch_stripes={self.max_batch_stripes}]")
                fut = self.backend.encode_many_lazy(self.code, data)
                if prev is not None:
                    sink(prev[0], self.backend.force(prev[1]))
                prev = (served, fut)
                served += 1
            if prev is not None:
                sink(prev[0], self.backend.force(prev[1]))
        return served

    # -- delta updates -------------------------------------------------------
    def _run_updates(self, ops_list: list[_Op], stats: FlushStats) -> None:
        # Waves: submission order, one op per stripe per wave (updates of
        # one stripe share parity blocks, so they must see each other's
        # writes), uniform payload length + reader cluster per wave so
        # the delta terms stack into one matmul.
        remaining = list(ops_list)
        while remaining:
            wave: list[_Op] = []
            stripes: set[int] = set()    # stripes in the wave OR deferred —
            key = None                   # keeps per-stripe submission order
            deferred: list[_Op] = []
            for op in remaining:
                okey = (len(op.new_data), op.reader_cluster)
                if op.stripe in stripes or (key is not None and okey != key):
                    deferred.append(op)
                    stripes.add(op.stripe)
                    continue
                key = okey
                stripes.add(op.stripe)
                wave.append(op)
            remaining = deferred
            self._run_update_wave(wave, stats)

    def _run_update_wave(self, wave: list[_Op], stats: FlushStats) -> None:
        code, k = self.code, self.code.k
        rc = wave[0].reader_cluster
        touched_of = {}
        read_pairs: list[tuple[int, int]] = []
        for op in wave:
            coeffs = code.A[:, op.block]
            touched_of[id(op)] = [int(pi) for pi in np.flatnonzero(coeffs)]
            read_pairs.append((op.stripe, op.block))
            read_pairs += [(op.stripe, k + pi) for pi in touched_of[id(op)]]
        # Stage phase: EVERY read happens before ANY write, one batched
        # get_many — a NodeFailure anywhere aborts the whole wave with
        # every stripe untouched.
        try:
            got = self.store.get_many(read_pairs, reader_cluster=rc)
        except Exception as exc:
            for op in wave:
                op.handle._fail(exc)
            return
        try:
            deltas, rows = [], []      # rows: (term row -> (op idx, pi))
            for u, op in enumerate(wave):
                old = np.frombuffer(got[(op.stripe, op.block)], np.uint8)
                new = np.frombuffer(op.new_data, np.uint8)
                if new.shape != old.shape:
                    raise ValueError(
                        f"update payload is {new.size} bytes but stripe "
                        f"{op.stripe} block {op.block} holds {old.size}")
                deltas.append(old ^ new)
                rows += [(u, pi) for pi in touched_of[id(op)]]
            if rows:
                # Block-structured coefficient matrix: one column per
                # update, one row per touched parity term — ALL delta
                # terms of the wave ride a single GF matmul.
                M = np.zeros((len(rows), len(wave)), dtype=np.uint8)
                for r, (u, pi) in enumerate(rows):
                    M[r, u] = code.A[pi, wave[u].block]
                terms = self.backend.delta_terms(M, np.stack(deltas))
        except Exception as exc:       # nothing written yet: wave aborts
            for op in wave:
                op.handle._fail(exc)
            return
        stats.update_waves += 1
        # Apply phase: every source value is staged, so no read can fail
        # between the first and last put. A put() error is a genuine
        # partial write — surface it on every unresolved handle rather
        # than stranding them pending forever.
        try:
            r = 0
            for u, op in enumerate(wave):
                sid = op.stripe
                self.store.put(sid, op.block,
                               self.store.node_of(sid, op.block),
                               op.new_data)
                for pi in touched_of[id(op)]:
                    pblock = k + pi
                    pold = np.frombuffer(got[(sid, pblock)], np.uint8)
                    self.store.put(sid, pblock,
                                   self.store.node_of(sid, pblock),
                                   (pold ^ terms[r]).tobytes())
                    r += 1
                op.handle._set(len(touched_of[id(op)]))
        except Exception as exc:
            for op in wave:
                if not op.handle.done:
                    op.handle._fail(exc)
