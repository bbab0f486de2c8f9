"""Zipf workload generation + deterministic virtual-time serving model
(port of `repro.io.workload`).

Heavy traffic on an erasure-coded store is an *open-loop* arrival
process (clients do not politely wait for the previous request) with
Zipf-skewed stripe popularity — a few hot stripes absorb most of the
traffic, which is exactly the regime where a failed node turns into a
same-block degraded-read storm. This module provides the three pieces a
saturation run composes (the reference's `benchmarks/fig_saturation.py`,
and `chip_smoke.py`'s front-end phase on the card):

  * `VirtualClock` — the injectable clock the front-end stamps latency
    with. Virtual time makes a run *deterministic*: p50/p99 and goodput
    come out of a modeled timeline, not a noisy wall clock. On the card
    the front-end can stamp with the wall clock instead while this clock
    only paces the open loop's ticks.
  * `ServiceModel` — maps what a class flush executed (a
    `ServiceSample`: launches, bytes, request count) to modeled service
    seconds; the front-end advances its shard's VirtualClock by that
    much per flush. Per-shard clocks accrue independently — the
    virtual-time rendering of shards flushing in parallel.
  * `ZipfWorkload` / `drive_open_loop` — deterministic Poisson arrivals
    over Zipf-ranked stripes and multiple tenants, and the tick-based
    open loop: submit everything that has arrived, advance every
    shard clock to the tick, flush, harvest completions. Latency is
    completion (shard frontier) minus *arrival* time, so queueing delay
    under overload is measured, not hidden.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator, Sequence

import numpy as np

from repro_torch.priority import Priority

__all__ = ["VirtualClock", "ServiceModel", "Arrival", "ZipfWorkload",
           "CompletedRequest", "drive_open_loop"]


class VirtualClock:
    """A monotonic clock the test/benchmark owns. `advance` models
    service time; `set_at_least` snaps an idle timeline forward to the
    open loop's master tick (time passes even when a shard has no
    work)."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("virtual time cannot go backwards")
        self._now += dt
        return self._now

    def set_at_least(self, t: float) -> float:
        self._now = max(self._now, t)
        return self._now


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Modeled service seconds for one class flush.

    Deliberately simple and *calibratable*: a fixed per-flush setup, a
    per-request overhead, a per-kernel-launch cost (decode/encode work —
    the term the hot-block cache removes), and a per-byte store/network
    cost. The defaults are the reference's, which approximate its
    interpret-mode magnitudes on a CPU: a model, not a measurement of
    any device."""
    per_flush_s: float = 200e-6
    per_request_s: float = 20e-6
    per_launch_s: float = 400e-6
    per_byte_s: float = 1.0 / (2 * 1024 ** 3)    # ~2 GiB/s byte path

    def __call__(self, sample) -> float:
        nbytes = sample.inner_bytes + sample.cross_bytes
        return (self.per_flush_s
                + sample.requests * self.per_request_s
                + sample.launches * self.per_launch_s
                + nbytes * self.per_byte_s)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One offered request: at time `t`, tenant `tenant` wants stripe
    `stripe`. What that *means* (client read vs degraded read vs an
    injected rebuild) is the submit callback's decision — availability
    is a property of the store at submit time, not of the workload."""
    t: float
    stripe: int
    tenant: str


class ZipfWorkload:
    """Deterministic open-loop workload: Poisson arrivals at
    `rate_rps`, stripe popularity Zipf(`theta`) over a seeded rank
    permutation (so the hot set is arbitrary stripes, not always stripe
    0), tenants drawn by weight. Same seed -> same arrival list."""

    def __init__(self, *, num_stripes: int, rate_rps: float,
                 duration_s: float, theta: float = 1.1,
                 tenants: Sequence[str] = ("tenant-0",),
                 tenant_weights: Sequence[float] | None = None,
                 seed: int = 0):
        if num_stripes < 1 or rate_rps <= 0 or duration_s <= 0:
            raise ValueError("need num_stripes >= 1, rate_rps > 0, "
                             "duration_s > 0")
        self.num_stripes = num_stripes
        self.rate_rps = rate_rps
        self.duration_s = duration_s
        self.theta = theta
        self.tenants = tuple(tenants)
        weights = tenant_weights or [1.0] * len(self.tenants)
        w = np.asarray(weights, dtype=np.float64)
        self._tenant_p = w / w.sum()
        self.seed = seed

    def stripe_probs(self) -> np.ndarray:
        ranks = 1.0 / np.power(np.arange(1, self.num_stripes + 1),
                               self.theta)
        probs = ranks / ranks.sum()
        perm = np.random.default_rng(self.seed ^ 0x5eed).permutation(
            self.num_stripes)
        out = np.empty_like(probs)
        out[perm] = probs
        return out

    def arrivals(self) -> list[Arrival]:
        rng = np.random.default_rng(self.seed)
        # Poisson process: exponential interarrivals, truncated at the
        # duration. Draw in one vectorized slab sized for the mean count
        # plus slack, extend in the (rare) case it falls short.
        expect = int(self.rate_rps * self.duration_s)
        gaps = rng.exponential(1.0 / self.rate_rps,
                               size=max(16, int(expect * 1.3) + 16))
        ts = np.cumsum(gaps)
        while ts[-1] < self.duration_s:
            more = rng.exponential(1.0 / self.rate_rps,
                                   size=max(16, expect // 4))
            ts = np.concatenate([ts, ts[-1] + np.cumsum(more)])
        ts = ts[ts <= self.duration_s]
        n = len(ts)
        stripes = rng.choice(self.num_stripes, size=n,
                             p=self.stripe_probs())
        tenant_idx = rng.choice(len(self.tenants), size=n,
                                p=self._tenant_p)
        return [Arrival(float(ts[i]), int(stripes[i]),
                        self.tenants[int(tenant_idx[i])])
                for i in range(n)]


@dataclasses.dataclass(frozen=True)
class CompletedRequest:
    """One harvested completion, timed against *arrival* (so queueing
    under overload shows up in the latency, unlike the handle's own
    submit-to-resolve stamp)."""
    arrival_t: float
    completion_t: float
    priority: Priority
    kind: str
    nbytes: int          # payload bytes delivered (0 for non-read results)
    shed: bool
    failed: bool

    @property
    def latency_s(self) -> float:
        return self.completion_t - self.arrival_t


def _harvest(outstanding, clocks, records) -> None:
    still = []
    for handle, arrival_t, shard_idx in outstanding:
        if not handle.done:
            still.append((handle, arrival_t, shard_idx))
            continue
        shed = handle.shed
        failed = False
        nbytes = 0
        if not shed:
            try:
                value = handle.result()
                if isinstance(value, (bytes, bytearray)):
                    nbytes = len(value)
            except Exception:
                failed = True
        records.append(CompletedRequest(
            arrival_t=arrival_t, completion_t=clocks[shard_idx](),
            priority=handle.priority, kind=handle.kind, nbytes=nbytes,
            shed=shed, failed=failed))
    outstanding[:] = still


def drive_open_loop(frontend, arrivals: Sequence[Arrival],
                    submit: Callable[[Arrival], object], *,
                    clocks: Sequence[VirtualClock],
                    num_shards: int, tick_s: float = 0.002,
                    on_tick: Callable[[float], Iterator | None] | None
                    = None) -> list[CompletedRequest]:
    """Tick-based open-loop execution of `arrivals` against `frontend`.

    Per tick: snap every shard clock forward to the master tick, submit
    everything that has arrived (via `submit`, which returns the
    handle), flush once (all shards, in parallel for a sharded
    front-end), harvest completions. `on_tick(t)`, if given, may inject
    extra submissions (the rebuild-storm scenario) and must return an
    iterable of (handle, arrival_t, shard_idx) to track, or None.
    Runs until every arrival is submitted and the frontend drains."""
    records: list[CompletedRequest] = []
    outstanding: list[tuple[object, float, int]] = []
    i, t = 0, 0.0
    while i < len(arrivals) or frontend.pending or outstanding:
        t += tick_s
        for clock in clocks:
            clock.set_at_least(t)
        while i < len(arrivals) and arrivals[i].t <= t:
            arrival = arrivals[i]
            handle = submit(arrival)
            outstanding.append(
                (handle, arrival.t, arrival.stripe % num_shards))
            i += 1
        if on_tick is not None:
            extra = on_tick(t)
            if extra:
                outstanding.extend(extra)
        frontend.flush()
        _harvest(outstanding, clocks, records)
    return records
