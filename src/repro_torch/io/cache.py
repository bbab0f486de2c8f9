"""HotBlockCache: degraded-read result cache for fan-in storms (port of
`repro.io.cache`).

The serving pathology of wide stripes (paper §2.2; "Making Wide Stripes
Practical", arXiv 2512.10425): one failed node turns every read of a
hot block it held into a *decode* — and a Zipf-skewed client population
hits the same few blocks over and over, so the coding path burns
O(requests) launches reproducing the same bytes. The cache collapses
that storm to O(1) decodes per distinct block: the first degraded read
decodes and inserts; every subsequent read of the same `(stripe,
block)` is served at submit time with zero engine ops.

Correctness is delegated to the store, not to call-site discipline:
`attach(store)` registers a mutation listener (`BlockStore.
add_mutation_listener`) so EVERY content mutation — client update,
rebuild re-placement, block drop, node-wide delete — invalidates the
key the moment it happens. Byte-identity of the cached and uncached
serving paths is therefore an invariant the tests can assert, not a
convention.

Thread-safe: one lock around the OrderedDict (the sharded front-end
probes from every shard worker; keys are stripe-sharded but the dict is
shared). LRU order is recency-of-hit, eviction pops the coldest entry
once `capacity_blocks` is exceeded.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

__all__ = ["CacheStats", "HotBlockCache"]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        probes = self.hits + self.misses
        return self.hits / probes if probes else 0.0


class HotBlockCache:
    """Size-bounded LRU of decoded block payloads keyed (stripe, block)."""

    def __init__(self, capacity_blocks: int = 256):
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.capacity_blocks = capacity_blocks
        self._entries: collections.OrderedDict[tuple[int, int], bytes] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._attached: set[int] = set()
        self.stats = CacheStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def attach(self, store) -> "HotBlockCache":
        """Subscribe to `store`'s mutation feed so writes, updates,
        drops, and rebuild re-placements invalidate eagerly. Idempotent
        per store (every shard of a front-end attaches the shared cache
        to the same store). Returns self, so calls chain."""
        with self._lock:
            if id(store) in self._attached:
                return self
            self._attached.add(id(store))
        store.add_mutation_listener(self.invalidate,
                                    batch=self.invalidate_many)
        return self

    def get(self, stripe: int, block: int) -> bytes | None:
        with self._lock:
            data = self._entries.get((stripe, block))
            if data is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end((stripe, block))
            self.stats.hits += 1
            return data

    def put(self, stripe: int, block: int, data: bytes) -> None:
        key = (stripe, block)
        with self._lock:
            self._entries[key] = bytes(data)
            self._entries.move_to_end(key)
            self.stats.insertions += 1
            while len(self._entries) > self.capacity_blocks:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def invalidate(self, stripe: int, block: int) -> None:
        with self._lock:
            if self._entries.pop((stripe, block), None) is not None:
                self.stats.invalidations += 1

    def invalidate_many(self, pairs) -> None:
        """Batched invalidation — the store's `put_many` mutation feed.
        Exactly as exact as per-pair `invalidate` (every pair is popped),
        but one lock acquisition for the whole batch instead of one per
        block of a 210-wide stripe."""
        with self._lock:
            for stripe, block in pairs:
                if self._entries.pop((stripe, block), None) is not None:
                    self.stats.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def contains(self, stripe: int, block: int) -> bool:
        """Presence probe that does NOT touch LRU order or hit/miss
        accounting (tests and introspection)."""
        with self._lock:
            return (stripe, block) in self._entries
