"""The one scheduling-priority vocabulary every layer shares (port of
`repro.priority`, all of it; stdlib only).

Two subsystems used to speak different dialects about the same thing:
the io front-end queued requests in CLIENT_READ / DEGRADED_READ /
BACKGROUND classes, while the repair scheduler ranked jobs with a
private integer ("multi-failure first"). RAFI-style risk-aware repair
(CR-SIM's `RAFIEventHandler` lineage) makes that split untenable: an
almost-exposed stripe's rebuild must be able to outrank ordinary
degraded-read traffic, which only works if repair risk tiers and
serving classes live on ONE scale.

`Priority` is that scale. The serving classes are the canonical
members; the repair risk tiers are *aliases* onto the same values, so
`Priority.URGENT is Priority.CLIENT_READ` — one enum, two readings:

  ==========  =============  ===========================================
  value       serving class  repair risk tier (aliases)
  ==========  =============  ===========================================
  0           CLIENT_READ    URGENT    — live erasures ≥ f: one more
                              failure in the stripe loses data, so its
                              repair rides ahead of everything
  1           DEGRADED_READ  EXPEDITED — 2 ≤ erasures < f: degraded but
                              not yet at the exposure edge
  2           BACKGROUND     NORMAL    — single erasure, routine
                              re-protect
  ==========  =============  ===========================================

This module sits below every other package (stdlib-only) so `io` and
a later simulator can import it without cycles. `ClassStats`
rides along because it is the generic per-class accounting record the
front-end (and anything else that batches by `Priority`) keeps, and the
admission-control vocabulary (`TokenBucket`, `QoSConfig`,
`AdmissionController`, `RequestShed`) lives here for the same reason:
it is pure policy over the shared priority scale, consumed by the io
front-end but importable by a simulator without touching torch.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import threading
import time
from collections.abc import Callable


class Priority(enum.IntEnum):
    """Lower value = served earlier. Client reads outrank repair —
    except URGENT repairs, which ARE client-priority work: losing the
    stripe would fail every future read of it."""
    CLIENT_READ = 0
    DEGRADED_READ = 1
    BACKGROUND = 2        # rebuild / scrub

    # RAFI risk-tier reading of the same scale (enum aliases: identity
    # holds, iteration does not repeat them).
    URGENT = 0
    EXPEDITED = 1
    NORMAL = 2


def tier_label(p: Priority) -> str:
    """The RAFI risk-tier reading of a priority value. Enum aliases do
    not surface through `.name` (`Priority(0).name` is "CLIENT_READ"),
    so reports about *repair* work use this to say URGENT/EXPEDITED/
    NORMAL instead of the serving-class spelling."""
    return {Priority.URGENT: "URGENT",
            Priority.EXPEDITED: "EXPEDITED",
            Priority.NORMAL: "NORMAL"}[Priority(p)]


def risk_tier(live_erasures: int, tolerable: int) -> Priority:
    """Map a stripe's live erasure count onto the shared scale.

    `tolerable` is f, the worst-case failure count the code always
    survives (core.mttdl.tolerable_failures). At `live_erasures >= f`
    the stripe is one failure from the edge — URGENT; two-or-more but
    below the edge is EXPEDITED; a single erasure is NORMAL
    re-protect. (f <= 1 codes have no EXPEDITED band: any
    multi-erasure is already at-or-past the edge.)"""
    if live_erasures >= max(tolerable, 2):
        return Priority.URGENT
    if live_erasures >= 2:
        return Priority.EXPEDITED
    return Priority.NORMAL


def failures_to_exposure(live_erasures: int, tolerable: int) -> int:
    """How many further failures until the stripe may be unrecoverable —
    the RAFI time-to-exposure ordinal (0 = the next failure can lose
    data). Within one risk tier, lower = repaired first."""
    return max(tolerable - live_erasures, 0)


@dataclasses.dataclass
class ClassStats:
    """Cumulative accounting for one priority class."""
    requests: int = 0
    failed_requests: int = 0
    blocks: int = 0              # blocks read/recovered/placed by the class
    launches: int = 0            # kernel launches attributed to the class
    inner_bytes: int = 0         # link tier: bytes that stayed behind a gateway
    cross_bytes: int = 0         # link tier: bytes that crossed a gateway
    aggregated_bytes: int = 0    # of cross_bytes: shipped as pre-folded blocks
    flushes: int = 0
    total_latency_s: float = 0.0
    max_latency_s: float = 0.0
    shed_requests: int = 0       # admission-rejected (never queued/served)
    deadline_misses: int = 0     # served, but past the class deadline
    cache_hits: int = 0          # served from the hot-block cache, zero ops

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / self.requests if self.requests else 0.0

    def merge(self, other: ClassStats) -> None:
        """Fold another shard's accounting into this record (the
        cross-shard ClassStats merge of the sharded front-end).
        `max_latency_s` is the max across shards; everything else sums."""
        self.requests += other.requests
        self.failed_requests += other.failed_requests
        self.blocks += other.blocks
        self.launches += other.launches
        self.inner_bytes += other.inner_bytes
        self.cross_bytes += other.cross_bytes
        self.aggregated_bytes += other.aggregated_bytes
        self.flushes += other.flushes
        self.total_latency_s += other.total_latency_s
        self.max_latency_s = max(self.max_latency_s, other.max_latency_s)
        self.shed_requests += other.shed_requests
        self.deadline_misses += other.deadline_misses
        self.cache_hits += other.cache_hits


def merge_class_stats(many: list[dict[Priority, ClassStats]]
                      ) -> dict[Priority, ClassStats]:
    """Merge per-shard {Priority: ClassStats} maps into one fresh map."""
    out = {p: ClassStats() for p in Priority}
    for stats in many:
        for p, cls in stats.items():
            out[Priority(p)].merge(cls)
    return out


class RequestShed(RuntimeError):
    """A request rejected by admission control. Carried on the request's
    handle (`result()` re-raises), never silently dropped — the caller
    sees WHY it was shed and the per-class `shed_requests` counter keeps
    the accounting invariant submitted == served + shed."""

    def __init__(self, reason: str, priority: Priority,
                 tenant: str | None = None):
        super().__init__(
            f"shed [{reason}] {Priority(priority).name}"
            + (f" tenant={tenant}" if tenant is not None else ""))
        self.reason = reason
        self.priority = Priority(priority)
        self.tenant = tenant


class TokenBucket:
    """Classic token bucket with an injectable clock (so QoS policy is
    testable without sleeps and deterministic under the benchmark's
    virtual time). Starts full; `try_take(n)` refills by elapsed * rate
    (capped at burst) and takes n tokens iff available."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] | None = None):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket needs rate > 0 and burst > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock or time.perf_counter
        self._tokens = self.burst
        self._last = self._clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens + 1e-12 < n:
                return False
            self._tokens -= n
            return True


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Admission policy knobs.

    Watermarks are pending-request counts at which load shedding starts,
    in strict degradation order: BACKGROUND sheds first (at
    `background_watermark`), DEGRADED_READ second (at the higher
    `degraded_watermark`); CLIENT_READ is never watermark-shed — under
    overload the system degrades sideways traffic before it degrades the
    paying path. Per-tenant token buckets (rate/burst in blocks) apply
    to every class including CLIENT_READ: a tenant over its reservation
    is shed regardless of class. `deadline_s` maps a class to its
    latency SLO; served requests past it count `deadline_misses`."""
    background_watermark: int | None = None
    degraded_watermark: int | None = None
    tenant_rate: float = math.inf     # blocks/second refill
    tenant_burst: float = math.inf    # bucket capacity, blocks
    deadline_s: dict[Priority, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if (self.background_watermark is not None
                and self.degraded_watermark is not None
                and self.degraded_watermark < self.background_watermark):
            raise ValueError(
                "degraded_watermark must be >= background_watermark: "
                "BACKGROUND always sheds before DEGRADED_READ")

    @property
    def metered_tenants(self) -> bool:
        return math.isfinite(self.tenant_rate) \
            or math.isfinite(self.tenant_burst)


class AdmissionController:
    """Admission decision point shared by every shard of a front-end.

    `admit()` returns None to admit or a shed-reason string; it charges
    the tenant's token bucket only when the request passes every check,
    so a watermark-shed request does not burn the tenant's tokens."""

    def __init__(self, config: QoSConfig | None = None, *,
                 clock: Callable[[], float] | None = None):
        self.config = config or QoSConfig()
        self._clock = clock or time.perf_counter
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def bucket_for(self, tenant: str) -> TokenBucket:
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                rate = self.config.tenant_rate
                burst = self.config.tenant_burst
                if not math.isfinite(rate):
                    rate = float("1e18")
                if not math.isfinite(burst):
                    burst = float("1e18")
                bucket = TokenBucket(rate, burst, self._clock)
                self._buckets[tenant] = bucket
        return bucket

    def admit(self, priority: Priority, size: int, *,
              pending: int, tenant: str | None = None) -> str | None:
        cfg = self.config
        priority = Priority(priority)
        if priority is Priority.BACKGROUND \
                and cfg.background_watermark is not None \
                and pending >= cfg.background_watermark:
            return "background-watermark"
        if priority is Priority.DEGRADED_READ \
                and cfg.degraded_watermark is not None \
                and pending >= cfg.degraded_watermark:
            return "degraded-watermark"
        if tenant is not None and cfg.metered_tenants \
                and not self.bucket_for(tenant).try_take(max(size, 1)):
            return "tenant-throttle"
        return None

    def deadline_for(self, priority: Priority) -> float | None:
        return self.config.deadline_s.get(Priority(priority))
