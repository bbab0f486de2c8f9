"""Priority-classed, shard-parallel serving layer over the CodingEngine
(port of `repro.io.frontend`).

The paper's availability argument (§2.2/§5) is about serving under
*frequent concurrent events*: many clients hitting degraded stripes at
once while background rebuild and scrub traffic competes for the same
coding path. Two layers provide that:

`RequestFrontend` — one shard's worth of the serving path:

  * requests (client read, degraded read, rebuild, scrub) queue in three
    priority classes — CLIENT_READ > DEGRADED_READ > BACKGROUND — and
    execute at flush boundaries, class by class, so a rebuild storm can
    never starve client reads;
  * within one class flush, every request's ops enter the engine before
    one `engine.flush()`: N concurrent degraded reads sharing a live
    erasure pattern coalesce into O(#patterns) kernel launches;
  * BACKGROUND work is metered by `background_ops_per_flush` — a storm
    is chunked across flush cycles, with leftover requests re-queued
    ahead of newly arriving background work;
  * admission control (`repro_torch.priority.AdmissionController`): per-tenant
    token buckets plus load-shedding watermarks — BACKGROUND sheds
    first, DEGRADED_READ second, CLIENT_READ never watermark-sheds. A
    shed request's handle resolves with `RequestShed` and counts in
    `ClassStats.shed_requests` (submitted == served + shed, exactly);
  * the degraded-read hot-block cache (`repro_torch.io.HotBlockCache`) sits in
    FRONT of the queue: a hit is served at submit time with zero engine
    ops, so a same-block degraded-read storm costs O(1) decodes instead
    of O(requests). Store mutation listeners invalidate eagerly, making
    cached/uncached byte-identity an invariant, not a convention;
  * time is injectable: `clock` (any `() -> float`) stamps submit and
    resolve, so latency accounting is deterministic under a
    `VirtualClock` and testable without sleeps, or real under the wall
    clock (the default). With a `service_model` hook, each class flush
    advances the (virtual) clock by the modeled service time of the work
    it just executed — a per-shard virtual timeline;
  * per-class accounting (`ClassStats`) via *thread-local* attribution
    scopes (`kernel_ops.launch_scope`, `TrafficStats.scoped`), so the
    numbers stay exact when many shards flush concurrently.

`ShardedFrontend` — the pipelined multi-shard composition: stripe
ownership is sharded by `stripe % num_shards`, each shard owning a
`StripeCodec.clone()` (fresh engine queue, shared store/metadata) so
submit -> plan -> flush overlap across shards on a worker pool while
kernels still batch per shard. Admission and the hot-block cache are
shared across shards; `stats` is the cross-shard `ClassStats` merge.
Multi-stripe requests (rebuild, scrub) split by shard and return a
merged handle; admission charges them once, at the sharded layer.

Requests are planned lazily AT flush time (availability is read then,
not at submit time) via the two-phase planner API on `StripeCodec`:
`plan_*` submits engine ops and returns a finish closure. Mutating
requests (rebuild placement) apply their writes in the finish phase,
after the class's batched reads have executed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.kernels import ops as kernel_ops
# Canonical home is repro_torch.priority (shared with a repair scheduler's
# risk tiers); re-exported here, as the reference does.
from repro_torch.priority import (AdmissionController, ClassStats, Priority,
                                  RequestShed, merge_class_stats)

from .cache import HotBlockCache

__all__ = ["Priority", "ClassStats", "ScrubReport", "RequestHandle",
           "MergedHandle", "ServiceSample", "RequestFrontend",
           "ShardedFrontend", "RequestShed"]


@dataclasses.dataclass(frozen=True)
class ScrubReport:
    """Background integrity pass: re-encode data blocks, compare parities."""
    stripes: int                 # stripes requested
    checked: int                 # stripes fully available and verified
    skipped: int                 # degraded stripes left to repair, not scrub
    mismatched: tuple[tuple[int, int], ...]   # (stripe, block) parity drift


@dataclasses.dataclass(frozen=True)
class ServiceSample:
    """What one class flush executed — the argument to the front-end's
    `service_model` hook, which maps it to modeled service seconds (the
    virtual-time cost charged per flush)."""
    priority: Priority
    requests: int
    blocks: int
    launches: int
    inner_bytes: int
    cross_bytes: int
    aggregated_bytes: int


class RequestHandle:
    """Future-like request result; resolved when its class flushes (or
    at submit time, for cache hits and admission sheds)."""

    __slots__ = ("priority", "kind", "size", "_done", "_value", "_exc",
                 "_clock", "_submitted", "latency_s")

    def __init__(self, priority: Priority, kind: str, size: int,
                 clock: Callable[[], float] = time.perf_counter):
        self.priority = priority
        self.kind = kind
        self.size = size                 # block count — the metering unit
        self._done = False
        self._value = None
        self._exc: BaseException | None = None
        self._clock = clock
        self._submitted = clock()
        self.latency_s = 0.0

    @property
    def done(self) -> bool:
        return self._done

    @property
    def shed(self) -> bool:
        return self._done and isinstance(self._exc, RequestShed)

    def _resolve(self, value, exc: BaseException | None) -> None:
        self._done, self._value, self._exc = True, value, exc
        self.latency_s = self._clock() - self._submitted

    def result(self):
        if not self._done:
            raise RuntimeError("request not flushed yet")
        if self._exc is not None:
            raise self._exc
        return self._value


class MergedHandle:
    """Handle over per-shard child handles of one multi-stripe request
    (rebuild/scrub split by stripe ownership). Resolves when every child
    has; `latency_s` is the slowest child's."""

    __slots__ = ("priority", "kind", "size", "_children", "_combine")

    def __init__(self, priority: Priority, kind: str, size: int,
                 children: list[RequestHandle],
                 combine: Callable[[list], object]):
        self.priority = priority
        self.kind = kind
        self.size = size
        self._children = children
        self._combine = combine

    @property
    def done(self) -> bool:
        return all(c.done for c in self._children)

    @property
    def shed(self) -> bool:
        return any(c.shed for c in self._children)

    @property
    def latency_s(self) -> float:
        return max((c.latency_s for c in self._children), default=0.0)

    def result(self):
        return self._combine([c.result() for c in self._children])


@dataclasses.dataclass(eq=False)
class _Request:
    handle: RequestHandle
    plan: Callable[[], Callable[[], object]]   # () -> finish closure


class RequestFrontend:
    """Coalescing, priority-classed request layer over one StripeCodec.

    One instance is one *shard*: `flush()`/`drain()` are driven by a
    single thread at a time (the sharded layer's worker pool guarantees
    this), while submissions and stat reads are safe from any thread."""

    def __init__(self, codec, *,
                 background_ops_per_flush: int | None = None,
                 clock: Callable[[], float] | None = None,
                 cache: HotBlockCache | None = None,
                 admission: AdmissionController | None = None,
                 admission_pending: Callable[[], int] | None = None,
                 service_model: Callable[[ServiceSample], float] | None = None,
                 deadline_s: dict[Priority, float] | None = None,
                 analyze_flushes: bool = False):
        if (background_ops_per_flush is not None
                and background_ops_per_flush < 1):
            raise ValueError("background_ops_per_flush must be >= 1")
        self.codec = codec
        self.background_ops_per_flush = background_ops_per_flush
        self.clock = clock or time.perf_counter
        self.cache = cache
        if cache is not None:
            cache.attach(codec.store)
        self.admission = admission
        # Watermark sheds are judged against this pending count — the
        # sharded layer points every shard at the GLOBAL backlog so one
        # hot shard cannot hide overload from the others.
        self._admission_pending = admission_pending or (lambda: self.pending)
        self.service_model = service_model
        if deadline_s is None and admission is not None:
            deadline_s = dict(admission.config.deadline_s)
        self.deadline_s = deadline_s or {}
        self.analyze_flushes = analyze_flushes
        self.hazard_checked_flushes = 0
        self._lock = threading.Lock()
        self._queues: dict[Priority, list[_Request]] = {
            p: [] for p in Priority}
        self.stats: dict[Priority, ClassStats] = {
            p: ClassStats() for p in Priority}

    # -- submission ----------------------------------------------------------
    def _shed(self, priority: Priority, kind: str, size: int,
              reason: str, tenant: str | None) -> RequestHandle:
        handle = RequestHandle(priority, kind, size, clock=self.clock)
        handle._resolve(None, RequestShed(reason, priority, tenant))
        with self._lock:
            self.stats[priority].shed_requests += 1
        return handle

    def _enqueue(self, priority: Priority, kind: str, size: int,
                 plan: Callable[[], Callable[[], object]], *,
                 tenant: str | None = None,
                 admitted: bool = False) -> RequestHandle:
        priority = Priority(priority)
        if self.admission is not None and not admitted:
            reason = self.admission.admit(
                priority, size, pending=self._admission_pending(),
                tenant=tenant)
            if reason is not None:
                return self._shed(priority, kind, size, reason, tenant)
        handle = RequestHandle(priority, kind, size, clock=self.clock)
        with self._lock:
            self._queues[priority].append(_Request(handle, plan))
        return handle

    def submit_client_read(self, meta, *,
                           reader_cluster: int | None = None,
                           tenant: str | None = None,
                           _admitted: bool = False) -> RequestHandle:
        """Full-stripe read (CheckpointManager-style restore traffic)."""
        return self._enqueue(
            Priority.CLIENT_READ, "client_read", self.codec.code.k,
            lambda: self.codec.plan_normal_read(
                meta, reader_cluster=reader_cluster),
            tenant=tenant, admitted=_admitted)

    def submit_degraded_read(self, meta, block: int, *,
                             reader_cluster: int | None = None,
                             tenant: str | None = None,
                             _admitted: bool = False) -> RequestHandle:
        """One unavailable block served from survivors — or from the
        hot-block cache, at submit time, with zero engine ops. A hit
        bypasses admission entirely: it never touches the coding path
        admission protects."""
        sid = meta.stripe_id
        if self.cache is not None:
            data = self.cache.get(sid, block)
            if data is not None:
                handle = RequestHandle(Priority.DEGRADED_READ,
                                       "degraded_read", 1, clock=self.clock)
                handle._resolve(data, None)
                with self._lock:
                    cls = self.stats[Priority.DEGRADED_READ]
                    cls.requests += 1
                    cls.blocks += 1
                    cls.cache_hits += 1
                    cls.total_latency_s += handle.latency_s
                    cls.max_latency_s = max(cls.max_latency_s,
                                            handle.latency_s)
                return handle
        return self._enqueue(
            Priority.DEGRADED_READ, "degraded_read", 1,
            lambda: self._plan_degraded(meta, block, reader_cluster),
            tenant=tenant, admitted=_admitted)

    def _plan_degraded(self, meta, block: int,
                       reader_cluster: int | None) -> Callable[[], bytes]:
        finish = self.codec.plan_degraded_read(
            meta, block, reader_cluster=reader_cluster)
        if self.cache is None:
            return finish
        sid = meta.stripe_id

        def finish_and_fill() -> bytes:
            data = finish()
            self.cache.put(sid, block, data)
            return data
        return finish_and_fill

    def submit_rebuild(self, pairs: list[tuple[int, int]], *,
                       reader_cluster: int | None = None,
                       exclude_node: int = -1,
                       priority: Priority = Priority.BACKGROUND,
                       tenant: str | None = None,
                       _admitted: bool = False) -> RequestHandle:
        """Re-protect; result is (placed, RecoveryStats). Routine rebuild
        rides BACKGROUND; the repair scheduler escalates an almost-exposed
        stripe's rebuild to its RAFI risk tier (URGENT/EXPEDITED alias
        onto the serving classes — see repro_torch.priority)."""
        return self._enqueue(
            Priority(priority), "rebuild", len(dict.fromkeys(pairs)),
            lambda: self.codec.plan_rebuild(
                pairs, reader_cluster=reader_cluster,
                exclude_node=exclude_node),
            tenant=tenant, admitted=_admitted)

    def submit_scrub(self, metas, *,
                     reader_cluster: int | None = None,
                     tenant: str | None = None,
                     _admitted: bool = False) -> RequestHandle:
        """Background integrity scan; result is a ScrubReport.

        One request reads every block of every listed stripe in its
        class flush, so its resident bytes scale with len(metas) — for
        checkpoint-scale scrubs submit slices of metas (and/or set
        background_ops_per_flush, which meters whole requests)."""
        return self._enqueue(
            Priority.BACKGROUND, "scrub",
            len(metas) * self.codec.code.n,
            lambda: self._plan_scrub(metas, reader_cluster),
            tenant=tenant, admitted=_admitted)

    def submit_checkpoint_write(self, buf: bytes, start_stripe: int, *,
                                window_stripes: int | None = None,
                                tenant: str | None = None,
                                _admitted: bool = False) -> RequestHandle:
        """Checkpoint write riding BACKGROUND class: the fused
        encode+put streaming pipeline (`StripeCodec.write_stream`) runs
        in the finish phase of its class flush — it drives its own
        double-buffered kernel launches through `encode_stream`, not the
        engine op queue, so the plan phase submits nothing. Result is
        the StripeMeta list. Size (metering/admission unit) is the
        stripes-to-write times n, the blocks the write will land."""
        k, bs = self.codec.code.k, self.codec.block_size
        nstripes = max(1, -(-len(buf) // (k * bs)))
        return self._enqueue(
            Priority.BACKGROUND, "checkpoint_write",
            nstripes * self.codec.code.n,
            lambda: (lambda: self.codec.write_stream(
                buf, start_stripe=start_stripe,
                window_stripes=window_stripes)),
            tenant=tenant, admitted=_admitted)

    # -- scrub planner -------------------------------------------------------
    def _plan_scrub(self, metas, reader_cluster: int | None):
        codec = self.codec
        n, k = codec.code.n, codec.code.k
        handles: dict[int, list] = {}
        skipped = 0
        for meta in metas:
            sid = meta.stripe_id
            if all(codec.store.available(sid, b) for b in range(n)):
                handles[sid] = [codec.engine.submit_read(
                    sid, b, reader_cluster=reader_cluster)
                    for b in range(n)]
            else:
                skipped += 1        # degraded: repair's job, not scrub's

        def finish() -> ScrubReport:
            mismatched: list[tuple[int, int]] = []
            sids = sorted(handles)
            # Re-encode in max_batch_stripes chunks so the numpy staging
            # + encode launch obey the engine's per-batch ceiling. The
            # flush's resolved read payloads still scale with the scrub's
            # total bytes — bound THAT by submitting large scrubs in
            # slices, or set background_ops_per_flush so the metering
            # spreads them across cycles.
            step = codec.max_batch_stripes
            for i0 in range(0, len(sids), step):
                chunk = sids[i0:i0 + step]
                stored = {sid: [np.frombuffer(h.result(), np.uint8)
                                for h in handles[sid]] for sid in chunk}
                data = np.stack([np.stack(stored[sid][:k])
                                 for sid in chunk])
                expect = codec.backend.encode_many(codec.code, data)
                for i, sid in enumerate(chunk):
                    for b in range(k, n):
                        if not np.array_equal(expect[i, b],
                                              stored[sid][b]):
                            mismatched.append((sid, b))
            return ScrubReport(stripes=len(metas), checked=len(handles),
                               skipped=skipped,
                               mismatched=tuple(mismatched))
        return finish

    # -- flush ---------------------------------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def _take(self, priority: Priority) -> list[_Request]:
        with self._lock:
            queue = self._queues[priority]
            if priority is not Priority.BACKGROUND \
                    or self.background_ops_per_flush is None:
                self._queues[priority] = []
                return queue
            take, size = [], 0
            while queue and (not take
                             or size + queue[0].handle.size
                             <= self.background_ops_per_flush):
                req = queue.pop(0)
                take.append(req)
                size += req.handle.size
            return take

    def flush(self) -> int:
        """One cycle: serve every class in priority order (client reads
        first, background last and metered). Returns requests served."""
        served = 0
        for priority in Priority:
            batch = self._take(priority)
            if not batch:
                continue
            served += len(batch)
            # Plan + execute + finish under thread-local attribution
            # scopes: the scrub finish phase launches encode kernels, so
            # the scope must cover the finishes too, not just the engine
            # flush. Outcomes are held back and resolved only after the
            # service model has advanced the clock, so handle latencies
            # include the modeled service time of their own flush.
            outcomes: list[tuple[_Request, object, BaseException | None]] = []
            with kernel_ops.launch_scope() as scope, \
                    self.codec.store.traffic.scoped() as tdelta:
                finishes: list[tuple[_Request, Callable | None,
                                     BaseException | None]] = []
                for req in batch:
                    try:
                        finishes.append((req, req.plan(), None))
                    except Exception as exc:
                        finishes.append((req, None, exc))
                self.codec.engine.flush(analyze=self.analyze_flushes)
                if self.analyze_flushes:
                    self.hazard_checked_flushes += 1
                for req, finish, exc in finishes:
                    if finish is None:
                        outcomes.append((req, None, exc))
                        continue
                    try:
                        outcomes.append((req, finish(), None))
                    except Exception as exc2:
                        outcomes.append((req, None, exc2))
            if self.service_model is not None:
                sample = ServiceSample(
                    priority=priority, requests=len(batch),
                    blocks=sum(req.handle.size for req in batch),
                    launches=scope.total, inner_bytes=tdelta.inner_bytes,
                    cross_bytes=tdelta.cross_bytes,
                    aggregated_bytes=tdelta.aggregated_bytes)
                self.clock.advance(self.service_model(sample))
            deadline = self.deadline_s.get(priority)
            with self._lock:
                cls = self.stats[priority]
                cls.flushes += 1
                for req, value, exc in outcomes:
                    req.handle._resolve(value, exc)
                    cls.requests += 1
                    cls.blocks += req.handle.size
                    if exc is not None:
                        cls.failed_requests += 1
                    cls.total_latency_s += req.handle.latency_s
                    cls.max_latency_s = max(cls.max_latency_s,
                                            req.handle.latency_s)
                    if deadline is not None \
                            and req.handle.latency_s > deadline:
                        cls.deadline_misses += 1
                cls.launches += scope.total
                cls.inner_bytes += tdelta.inner_bytes
                cls.cross_bytes += tdelta.cross_bytes
                cls.aggregated_bytes += tdelta.aggregated_bytes
        return served

    def drain(self) -> int:
        """Flush cycles until every queue is empty (background metering
        spreads a storm over several cycles). Returns requests served."""
        served = 0
        while self.pending:
            served += self.flush()
        return served

    # -- repair-scheduler convenience ---------------------------------------
    def rebuild(self, pairs: list[tuple[int, int]], *,
                reader_cluster: int | None = None,
                exclude_node: int = -1,
                priority: Priority = Priority.BACKGROUND):
        """Submit one rebuild request and drain it immediately, returning
        the same `RepairReport` the codec's synchronous path produces —
        the hook a repair simulator's data-path mode drives. The scopes are
        thread-local, so the deltas stay exact even when other shards
        flush concurrently; concurrent requests on THIS shard fold into
        the drain window, as before."""
        from repro_torch.ckpt.stripe import RepairReport
        requested = len(dict.fromkeys(pairs))
        with kernel_ops.launch_scope() as scope, \
                self.codec.store.traffic.scoped() as tdelta:
            handle = self.submit_rebuild(pairs,
                                         reader_cluster=reader_cluster,
                                         exclude_node=exclude_node,
                                         priority=priority)
            self.drain()
            placed, stats = handle.result()
        return RepairReport(
            requested=requested, placed=placed,
            launches=scope.total,
            inner_bytes=tdelta.inner_bytes,
            cross_bytes=tdelta.cross_bytes,
            plan_groups=stats.plan_groups, patterns=stats.pattern_groups,
            multi_pairs=stats.multi_pairs,
            aggregated_bytes=tdelta.aggregated_bytes)


class ShardedFrontend:
    """Pipelined multi-shard serving layer: `num_shards` RequestFrontend
    shards, stripe ownership `stripe % num_shards`, flushed in parallel
    on a worker pool. Admission and the hot-block cache are shared;
    `stats` is the cross-shard merge. Each shard plans and flushes on
    its own `StripeCodec.clone()` (fresh engine queue, shared store and
    stripe metadata), so kernels batch per shard while shards overlap.

    `clock_factory(shard_index) -> clock` gives each shard its own
    timeline — under `VirtualClock`s, shard service times accrue
    independently, which is exactly the parallelism the wall clock would
    show on real hardware, minus the noise."""

    def __init__(self, codec, *, num_shards: int = 1,
                 background_ops_per_flush: int | None = None,
                 cache: HotBlockCache | None = None,
                 admission: AdmissionController | None = None,
                 clock: Callable[[], float] | None = None,
                 clock_factory: Callable[[int], Callable[[], float]] | None
                 = None,
                 service_model: Callable[[ServiceSample], float] | None
                 = None,
                 deadline_s: dict[Priority, float] | None = None,
                 analyze_flushes: bool = False):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.codec = codec
        self.num_shards = num_shards
        self.cache = cache
        self.admission = admission
        codecs = [codec] + [codec.clone() for _ in range(num_shards - 1)]
        if clock_factory is not None:
            self.clocks = [clock_factory(i) for i in range(num_shards)]
        else:
            self.clocks = [clock or time.perf_counter] * num_shards
        self.shards = [
            RequestFrontend(
                codecs[i],
                background_ops_per_flush=background_ops_per_flush,
                clock=self.clocks[i], cache=cache, admission=admission,
                admission_pending=lambda: self.pending,
                service_model=service_model, deadline_s=deadline_s,
                analyze_flushes=analyze_flushes)
            for i in range(num_shards)]
        # Merged-submission sheds (rebuild/scrub rejected before any
        # shard saw them) are accounted here; `stats` folds them in.
        self._shed_stats = {p: ClassStats() for p in Priority}
        self._shed_lock = threading.Lock()
        self._pool = (ThreadPoolExecutor(
            max_workers=num_shards,
            thread_name_prefix="shard-flush")
            if num_shards > 1 else None)

    # -- routing -------------------------------------------------------------
    def shard_of(self, stripe: int) -> RequestFrontend:
        return self.shards[stripe % self.num_shards]

    def submit_client_read(self, meta, *,
                           reader_cluster: int | None = None,
                           tenant: str | None = None) -> RequestHandle:
        return self.shard_of(meta.stripe_id).submit_client_read(
            meta, reader_cluster=reader_cluster, tenant=tenant)

    def submit_degraded_read(self, meta, block: int, *,
                             reader_cluster: int | None = None,
                             tenant: str | None = None) -> RequestHandle:
        return self.shard_of(meta.stripe_id).submit_degraded_read(
            meta, block, reader_cluster=reader_cluster, tenant=tenant)

    def _admit_merged(self, priority: Priority, kind: str, size: int,
                      tenant: str | None):
        """Admission for a multi-stripe submission, charged ONCE here —
        the per-shard children bypass shard admission, so a split
        request can never be half-shed."""
        if self.admission is None:
            return None
        reason = self.admission.admit(priority, size,
                                      pending=self.pending, tenant=tenant)
        if reason is None:
            return None
        handle = RequestHandle(priority, kind, size)
        handle._resolve(None, RequestShed(reason, priority, tenant))
        with self._shed_lock:
            self._shed_stats[priority].shed_requests += 1
        return handle

    def submit_rebuild(self, pairs: list[tuple[int, int]], *,
                       reader_cluster: int | None = None,
                       exclude_node: int = -1,
                       priority: Priority = Priority.BACKGROUND,
                       tenant: str | None = None):
        """Rebuild across stripe ownership: pairs split by shard, one
        child rebuild each, merged (placed, RecoveryStats) result."""
        pairs = list(dict.fromkeys(pairs))
        priority = Priority(priority)
        shed = self._admit_merged(priority, "rebuild", len(pairs), tenant)
        if shed is not None:
            return shed
        by_shard: dict[int, list[tuple[int, int]]] = {}
        for s, b in pairs:
            by_shard.setdefault(s % self.num_shards, []).append((s, b))
        children = [
            self.shards[i].submit_rebuild(
                chunk, reader_cluster=reader_cluster,
                exclude_node=exclude_node, priority=priority,
                _admitted=True)
            for i, chunk in sorted(by_shard.items())]
        if len(children) == 1:
            return children[0]

        def combine(values):
            from repro_torch.ckpt.stripe import RecoveryStats
            placed = sum(v[0] for v in values)
            stats = RecoveryStats(
                fast_groups=sum(v[1].fast_groups for v in values),
                pattern_groups=sum(v[1].pattern_groups for v in values),
                fast_pairs=sum(v[1].fast_pairs for v in values),
                multi_pairs=sum(v[1].multi_pairs for v in values))
            return placed, stats
        return MergedHandle(priority, "rebuild", len(pairs), children,
                            combine)

    def submit_scrub(self, metas, *,
                     reader_cluster: int | None = None,
                     tenant: str | None = None):
        metas = list(metas)
        size = len(metas) * self.codec.code.n
        shed = self._admit_merged(Priority.BACKGROUND, "scrub", size,
                                  tenant)
        if shed is not None:
            return shed
        by_shard: dict[int, list] = {}
        for meta in metas:
            by_shard.setdefault(meta.stripe_id % self.num_shards,
                                []).append(meta)
        children = [
            self.shards[i].submit_scrub(
                chunk, reader_cluster=reader_cluster, _admitted=True)
            for i, chunk in sorted(by_shard.items())]
        if len(children) == 1:
            return children[0]

        def combine(values):
            mismatched: list[tuple[int, int]] = []
            for v in values:
                mismatched.extend(v.mismatched)
            return ScrubReport(
                stripes=sum(v.stripes for v in values),
                checked=sum(v.checked for v in values),
                skipped=sum(v.skipped for v in values),
                mismatched=tuple(sorted(mismatched)))
        return MergedHandle(Priority.BACKGROUND, "scrub", size, children,
                            combine)

    def submit_checkpoint_write(self, buf: bytes, start_stripe: int, *,
                                window_stripes: int | None = None,
                                tenant: str | None = None):
        """Checkpoint write routed whole to the shard owning
        `start_stripe`: the streamed write is one fused pipeline over
        consecutive stripes (splitting it would serialize the double
        buffer), and stripe metadata is shared across clones so every
        shard sees the landed stripes. Admission is charged once here,
        like other multi-stripe submissions."""
        k, bs = self.codec.code.k, self.codec.block_size
        nstripes = max(1, -(-len(buf) // (k * bs)))
        size = nstripes * self.codec.code.n
        shed = self._admit_merged(Priority.BACKGROUND, "checkpoint_write",
                                  size, tenant)
        if shed is not None:
            return shed
        return self.shard_of(start_stripe).submit_checkpoint_write(
            buf, start_stripe, window_stripes=window_stripes,
            tenant=tenant, _admitted=True)

    # -- flush ---------------------------------------------------------------
    @property
    def pending(self) -> int:
        return sum(shard.pending for shard in self.shards)

    def flush(self) -> int:
        """One cycle on every shard — in parallel on the worker pool when
        num_shards > 1. Per-shard flushes keep the class order (client
        reads first, metered background last) independently; cross-shard
        they overlap, which is the pipeline."""
        if self._pool is None:
            return self.shards[0].flush()
        futures = [self._pool.submit(shard.flush)
                   for shard in self.shards]
        return sum(f.result() for f in futures)

    def drain(self) -> int:
        served = 0
        while self.pending:
            served += self.flush()
        return served

    # -- accounting ----------------------------------------------------------
    @property
    def stats(self) -> dict[Priority, ClassStats]:
        """Cross-shard ClassStats merge (plus merged-submission sheds)."""
        with self._shed_lock:
            return merge_class_stats(
                [shard.stats for shard in self.shards]
                + [self._shed_stats])

    @property
    def hazard_checked_flushes(self) -> int:
        return sum(shard.hazard_checked_flushes for shard in self.shards)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "ShardedFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
