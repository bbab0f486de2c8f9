"""Topology-aware block placement (paper §2.3.2, §3.1).

Two strategies:
  * UniLRC native: "one local group, one cluster" (z clusters) — zero
    cross-cluster recovery traffic by construction, plus the relaxed
    "one local group, t clusters" variant for small-z deployments (§3.3
    Discussion).
  * ECWide (Hu et al., FAST'21) for the baselines: pack blocks into the
    minimum number of clusters subject to tolerating one cluster failure
    (each cluster holds at most d-1 blocks of a stripe), keeping each local
    group in as few clusters as possible.
"""
from __future__ import annotations

import numpy as np

from repro_torch.topo import cross_cluster_blocks

from .codes import Code


class Placement:
    """placement[i] = cluster id of block i."""

    def __init__(self, code: Code, assignment: list[int], name: str):
        self.code = code
        self.assignment = list(assignment)
        self.name = name
        assert len(self.assignment) == code.n

    @property
    def num_clusters(self) -> int:
        return max(self.assignment) + 1

    def cluster_blocks(self, c: int) -> list[int]:
        return [i for i, a in enumerate(self.assignment) if a == c]

    def blocks_by_cluster(self) -> list[list[int]]:
        """One pass over the assignment: cluster id -> its block ids.
        The simulator calls this per correlated cluster-loss event, where
        the per-cluster `cluster_blocks` scan would be O(n·z)."""
        out: list[list[int]] = [[] for _ in range(self.num_clusters)]
        for i, a in enumerate(self.assignment):
            out[a].append(i)
        return out

    def cluster_sizes(self) -> list[int]:
        return [len(b) for b in self.blocks_by_cluster()]

    def cross_cluster_cost(self, target: int, sources,
                           aggregate: bool = False) -> int:
        """# source blocks living outside the failed block's cluster.

        Thin shim over `repro_torch.topo.cross_cluster_blocks` — the topology
        subsystem owns cluster arithmetic now. aggregate=True models
        gateway XOR aggregation (each remote cluster pre-folds its
        members and ships ONE block) — the reading under which the
        paper's §3.3 claim "only t−1 blocks of cross-cluster traffic"
        holds for the relaxed placement. Only valid for XOR-linear
        recovery plans; callers with a plan in hand should use
        `NetworkModel.recovery_blocks`, which checks that validity."""
        return cross_cluster_blocks(self.assignment, target, sources,
                                    aggregate=aggregate)

    def tolerates_one_cluster_failure(self) -> bool:
        """Check every single-cluster wipe-out is decodable (used in tests)."""
        from .codec import decode_plan_cached
        for c in range(self.num_clusters):
            blocks = self.cluster_blocks(c)
            if not blocks:
                continue
            try:
                decode_plan_cached(self.code, tuple(blocks))
            except ValueError:
                return False
        return True


def place_unilrc(code: Code) -> Placement:
    """One local group -> one cluster (paper Fig 4)."""
    assert code.meta.get("family") == "unilrc"
    assignment = [-1] * code.n
    for ci, grp in enumerate(code.groups):
        for b in grp:
            assignment[b] = ci
    assert all(a >= 0 for a in assignment)
    return Placement(code, assignment, "one-group-one-cluster")


def place_unilrc_relaxed(code: Code, t: int) -> Placement:
    """'One local group, t clusters' (§3.3): split each group across t
    clusters for small-scale DSSs — trades t-1 cross-cluster blocks per
    recovery for fewer local parities at higher rate."""
    assert code.meta.get("family") == "unilrc" and t >= 1
    assignment = [-1] * code.n
    next_cluster = 0
    for grp in code.groups:
        parts = np.array_split(np.array(grp), t)
        for part in parts:
            for b in part:
                assignment[int(b)] = next_cluster
            next_cluster += 1
    return Placement(code, assignment, f"one-group-{t}-clusters")


def place_ecwide(code: Code) -> Placement:
    """ECWide-style placement for baseline codes (paper Fig 2).

    Rule (Hu et al. FAST'21, "combined locality"): pack each local group
    into the *minimum* number of clusters such that losing any one cluster
    remains a decodable erasure pattern. In the paper's Fig 2 example this
    keeps the 8-wide ULRC groups in one cluster each (a full-group loss is
    still recoverable via the global parities) and splits the 9-wide groups
    in two. Distinct local groups do not share clusters.
    """
    from .codec import decode_plan_cached

    def _decodable(blocks: list[int]) -> bool:
        try:
            decode_plan_cached(code, tuple(blocks))
            return True
        except ValueError:
            return False

    def _greedy_chunks(members: list[int]) -> list[list[int]]:
        """Split into the fewest clusters, taking the largest decodable
        prefix each time (uneven splits — paper Fig 2(a): an 8+1 split
        leaves the 8 majority blocks needing only one cross-cluster read)."""
        chunks = []
        rest = list(members)
        while rest:
            for s in range(len(rest), 0, -1):
                if _decodable(rest[:s]):
                    chunks.append(rest[:s])
                    rest = rest[s:]
                    break
            else:
                raise ValueError(f"{code.name}: single block {rest[0]} "
                                 f"not decodable — broken code")
        return chunks

    assignment = [-1] * code.n
    next_cluster = 0
    covered = set()
    # Groups listed in code.groups cover data+locals (+globals for some
    # families); any uncovered blocks (e.g. ALRC globals) go last.
    group_pools = []
    for grp in code.groups:
        members = [b for b in grp if b not in covered]
        if members:
            covered.update(members)
            group_pools.append(members)
    rest = [b for b in range(code.n) if b not in covered]
    if rest:
        group_pools.append(rest)
    for members in group_pools:
        for chunk in _greedy_chunks(members):
            for b in chunk:
                assignment[int(b)] = next_cluster
            next_cluster += 1
    assert all(a >= 0 for a in assignment)
    return Placement(code, assignment, "ecwide")


def default_placement(code: Code) -> Placement:
    if code.meta.get("family") == "unilrc":
        return place_unilrc(code)
    return place_ecwide(code)
