"""Encode/decode engine: single-failure recovery plans and multi-erasure
decoding for any `Code`.

The *plan* layer is pure metadata (which blocks to read, with which GF
coefficients); the *bulk byte path* is executed by the CUDA kernels
(kernels/ops.py) or the numpy oracle here. Host-side copy of
`repro.core.codec` for the PyTorch port. The decode-matrix solve is a tiny
O((n-k)^3) host-side GF Gaussian elimination, run once per erasure pattern —
exactly how production EC libraries (ISA-L et al.) structure it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .codes import Code
from .gf import GF_MUL_TABLE, gf_inv, gf_matmul, gf_rank, gf_solve


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """Recover `target` as sum_j coeffs[j] * blocks[sources[j]]."""
    target: int
    sources: tuple[int, ...]
    coeffs: tuple[int, ...]

    @property
    def cost(self) -> int:
        return len(self.sources)

    @property
    def xor_only(self) -> bool:
        return all(c == 1 for c in self.coeffs)

    def apply(self, blocks: dict[int, np.ndarray]) -> np.ndarray:
        """Numpy/oracle execution of the plan."""
        out = None
        for s, c in zip(self.sources, self.coeffs):
            term = blocks[s] if c == 1 else GF_MUL_TABLE[np.uint8(c), blocks[s]]
            out = term.copy() if out is None else out ^ term
        return out


def single_recovery_plan(code: Code, target: int) -> RecoveryPlan:
    """Minimal-cost single-failure recovery plan from the code's checks.

    Picks the parity-check vector with smallest support containing `target`;
    sources = support minus {target}, coefficients c_j = h_j / h_target.
    """
    best = None
    for h in code.checks:
        if h[target] == 0:
            continue
        support = np.flatnonzero(h)
        if best is None or len(support) < len(best[0]):
            best = (support, h)
    if best is None:
        raise ValueError(f"no check covers block {target} in {code.name}")
    support, h = best
    inv_t = gf_inv(h[target])
    sources, coeffs = [], []
    for j in support:
        if j == int(target):
            continue
        sources.append(int(j))
        coeffs.append(int(GF_MUL_TABLE[inv_t, h[j]]))
    return RecoveryPlan(int(target), tuple(sources), tuple(coeffs))


def all_recovery_plans(code: Code) -> list[RecoveryPlan]:
    return [single_recovery_plan(code, i) for i in range(code.n)]


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Recover blocks `erased` from `sources`:
    recovered = M @ blocks[sources]  (GF(2^8) matmul)."""
    erased: tuple[int, ...]
    sources: tuple[int, ...]
    M: np.ndarray  # (len(erased), len(sources)) uint8

    def apply(self, blocks: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
        src = np.stack([blocks[s] for s in self.sources]).astype(np.uint8)
        flat = src.reshape(len(self.sources), -1)
        rec = gf_matmul(self.M, flat).reshape(len(self.erased), *src.shape[1:])
        return {e: rec[i] for i, e in enumerate(self.erased)}


def decode_plan(code: Code, erased: tuple[int, ...] | list[int]) -> DecodePlan:
    """General multi-erasure decode.

    Strategy (mirrors the paper's §4.1 workflow):
      1. Repeatedly apply single-failure local plans while some erased block
         has a check whose other members are all alive (cheap XOR path —
         handles every single failure and most correlated-within-group
         patterns with group-local traffic only).
      2. For whatever remains, solve globally: pick k independent surviving
         generator rows, express erased symbols over them.

    Raises ValueError if the pattern exceeds the code's erasure tolerance.
    """
    erased = tuple(sorted({int(e) for e in erased}))
    if not erased:
        return _sealed_plan((), (), np.zeros((0, 0), dtype=np.uint8))
    alive = [i for i in range(code.n) if i not in erased]
    if len(alive) < code.k:
        raise ValueError("more erasures than parities")

    n, k = code.n, code.k
    # Express every symbol over the k data symbols: rows of G.
    G = code.G  # (n, k)

    # Step 1: peel locally.  Track, for each erased block, a linear plan
    # over *alive* blocks where possible.
    pending = set(erased)
    plan_rows: dict[int, dict[int, int]] = {}  # target -> {source: coeff}
    resolved_order: list[int] = []
    progress = True
    while progress and pending:
        progress = False
        for t in sorted(pending):
            for h in code.checks:
                if h[t] == 0:
                    continue
                support = np.flatnonzero(h)
                others = [int(j) for j in support if j != t]
                if any((j in pending) for j in others):
                    continue
                # all other members alive or already resolved
                inv_t = gf_inv(h[t])
                row: dict[int, int] = {}

                def _add(j: int, c: int, row=row):
                    if c == 0:
                        return
                    row[j] = int(row.get(j, 0) ^ c)
                    if row[j] == 0:
                        del row[j]

                for j in others:
                    c = int(GF_MUL_TABLE[inv_t, h[j]])
                    if j in plan_rows:  # substitute resolved erased block
                        for s2, c2 in plan_rows[j].items():
                            _add(s2, int(GF_MUL_TABLE[c, c2]))
                    else:
                        _add(j, c)
                plan_rows[t] = row
                resolved_order.append(t)
                pending.discard(t)
                progress = True
                break

    # Step 2: global solve for the rest, exploiting systematic structure.
    # Alive data rows are identity rows; we only need to solve for the
    # erased *data* symbols from alive parity rows restricted to the
    # erased-data columns (a tiny (#erased_data)^2 GF system).
    if pending:
        erased_all = set(erased)
        erased_data = sorted(i for i in erased_all if i < k)
        alive_data = [i for i in range(k) if i not in erased_all]
        alive_par = [i for i in alive if i >= k]
        ed_pos = {e: i for i, e in enumerate(erased_data)}
        m = len(erased_data)
        # Greedily pick m alive parity rows independent on erased-data cols.
        sel_par: list[int] = []
        R = np.zeros((0, m), dtype=np.uint8)
        for p in alive_par:
            if len(sel_par) == m:
                break
            restr = code.A[p - k, erased_data][None, :]
            cand = np.concatenate([R, restr], axis=0)
            if gf_rank(cand) == len(cand):
                R = cand
                sel_par.append(p)
        if len(sel_par) < m:
            raise ValueError(
                f"{code.name}: erasure pattern {erased} not decodable "
                f"(only {len(sel_par)} independent parities for "
                f"{m} erased data blocks)")
        # R @ x_erased = parity_values - A[:, alive_data] @ x_alive
        Rinv = gf_solve(R, np.eye(m, dtype=np.uint8)) if m else R
        # x_erased[i] = sum_j Rinv[i,j] * (block[sel_par[j]]
        #                                  + sum_{a in alive_data} A[j,a] blk[a])
        data_rows: dict[int, dict[int, int]] = {}
        for i, e in enumerate(erased_data):
            row: dict[int, int] = {}
            for j, p in enumerate(sel_par):
                c = int(Rinv[i, j])
                if c == 0:
                    continue
                row[p] = int(row.get(p, 0) ^ c)
                arow = code.A[p - k]
                for a in alive_data:
                    ca = int(GF_MUL_TABLE[c, arow[a]])
                    if ca:
                        row[a] = int(row.get(a, 0) ^ ca)
            data_rows[e] = {s: c for s, c in row.items() if c != 0}
        # Now express every pending symbol over alive blocks.
        for t in sorted(pending):
            if t < k:
                plan_rows[t] = data_rows[t]
            else:
                # parity t = A[t-k] @ x ; substitute erased data symbols.
                row: dict[int, int] = {}
                arow = code.A[t - k]
                for a in range(k):
                    c = int(arow[a])
                    if c == 0:
                        continue
                    if a in erased_all:
                        for s2, c2 in data_rows[a].items():
                            cc = int(GF_MUL_TABLE[c, c2])
                            if cc:
                                row[s2] = int(row.get(s2, 0) ^ cc)
                                if row[s2] == 0:
                                    del row[s2]
                    else:
                        row[a] = int(row.get(a, 0) ^ c)
                        if row[a] == 0:
                            del row[a]
                plan_rows[t] = {s: c for s, c in row.items() if c != 0}
            resolved_order.append(t)
        pending.clear()

    sources = sorted({s for row in plan_rows.values() for s in row})
    src_pos = {s: i for i, s in enumerate(sources)}
    M = np.zeros((len(erased), len(sources)), dtype=np.uint8)
    for i, t in enumerate(erased):
        for s, c in plan_rows[t].items():
            M[i, src_pos[s]] = c
    return _sealed_plan(erased, tuple(sources), M)


def _sealed_plan(erased: tuple[int, ...], sources: tuple[int, ...],
                 M: np.ndarray) -> DecodePlan:
    """Every DecodePlan is born with a read-only matrix: plans are shared
    through the memo cache, so an in-place edit would silently corrupt
    every other holder's decodes. Writers fail loudly instead."""
    M.setflags(write=False)
    return DecodePlan(erased, sources, M)


# ---------------------------------------------------------------------------
# Plan cache — the metadata layer is computed once per (code, pattern).
#
# `Code` holds numpy arrays so it is neither hashable nor weakref-safe under
# the generated dataclass __eq__; the cache is keyed by code *content*
# (name + dimensions + coefficient bytes), so two equal constructions share
# one cache entry. Plan construction runs GF Gaussian elimination — tiny in
# absolute terms, but on the repair hot path it used to run once per stripe.
# ---------------------------------------------------------------------------

class _PlanCache:
    __slots__ = ("singles", "decodes")

    def __init__(self):
        self.singles: tuple[RecoveryPlan, ...] | None = None
        self.decodes: dict[tuple[int, ...], DecodePlan] = {}


_PLAN_CACHES: dict[tuple, _PlanCache] = {}
_MAX_CODES = 64            # parameter sweeps construct many distinct codes
_MAX_DECODE_PLANS = 4096   # per code; long failure-injection runs vary patterns


def _code_key(code: Code) -> tuple:
    return (code.name, code.n, code.k,
            code.A.tobytes(), code.checks.tobytes())


def _cache_for(code: Code) -> _PlanCache:
    key = _code_key(code)
    cache = _PLAN_CACHES.get(key)
    if cache is None:
        if len(_PLAN_CACHES) >= _MAX_CODES:       # FIFO bound, like the
            _PLAN_CACHES.pop(next(iter(_PLAN_CACHES)))  # kernel a_bits cache
        cache = _PLAN_CACHES[key] = _PlanCache()
    return cache


def plans_for(code: Code) -> tuple[RecoveryPlan, ...]:
    """All single-failure recovery plans for `code`, built once and memoized.

    `plans_for(code)[i]` is the minimal plan for block i — same contents as
    `single_recovery_plan(code, i)` but cached, so the stripe layer can ask
    per block per stripe without re-scanning the check matrix."""
    cache = _cache_for(code)
    if cache.singles is None:
        cache.singles = tuple(all_recovery_plans(code))
    return cache.singles


def decode_plan_cached(code: Code,
                       erased: tuple[int, ...] | list[int]) -> DecodePlan:
    """Memoized `decode_plan`: one Gaussian elimination per (code, pattern).

    The pattern is normalized (sorted, deduplicated), and repeated calls
    return the *identical* DecodePlan object — callers may key batched work
    by plan identity. The cache is FIFO-bounded per code, so identity is
    guaranteed only within a window of _MAX_DECODE_PLANS distinct
    patterns."""
    pattern = tuple(sorted({int(e) for e in erased}))
    cache = _cache_for(code)
    plan = cache.decodes.get(pattern)
    if plan is None:
        plan = decode_plan(code, pattern)  # M already sealed read-only
        if len(cache.decodes) >= _MAX_DECODE_PLANS:
            cache.decodes.pop(next(iter(cache.decodes)))
        cache.decodes[pattern] = plan
    return plan


def cached_decode_plans(code: Code) -> tuple[DecodePlan, ...]:
    """Snapshot of every DecodePlan currently memoized for `code`.

    The symbolic verifier walks this to certify that what the engines
    will actually *execute* (they decode through `decode_plan_cached`)
    inverts its erasure pattern — not just freshly-built plans."""
    cache = _PLAN_CACHES.get(_code_key(code))
    if cache is None:
        return ()
    return tuple(cache.decodes.values())


def clear_plan_caches() -> None:
    """Drop every memoized plan (tests / long-lived processes)."""
    _PLAN_CACHES.clear()


def verify_erasure_tolerance(code: Code, num_erasures: int,
                             trials: int = 50, seed: int = 0) -> bool:
    """Randomized check: `num_erasures` random erasures always decodable
    and decode reproduces the original blocks."""
    rng = np.random.default_rng(seed)
    B = 64
    data = rng.integers(0, 256, size=(code.k, B), dtype=np.uint8)
    codeword = code.encode(data)
    for _ in range(trials):
        erased = rng.choice(code.n, size=num_erasures, replace=False)
        plan = decode_plan(code, tuple(int(e) for e in erased))
        blocks = {i: codeword[i] for i in range(code.n) if i not in set(erased.tolist())}
        rec = plan.apply(blocks)
        for e in erased:
            if not np.array_equal(rec[int(e)], codeword[int(e)]):
                return False
    return True

