"""Code constructions: UniLRC (the paper, §3.2) + deployed baselines.

Baselines (paper §2.3/§5): ALRC (Azure-LRC, Huang et al. ATC'12),
OLRC (Optimal Cauchy LRC, Google FAST'23), ULRC (Uniform Cauchy LRC,
Google FAST'23).

Codeword symbol order is systematic: [d_0..d_{k-1} | parities].
Each code records:
  * A        — (n-k, k) parity coefficient matrix (parity = A @ data over GF(2^8))
  * groups   — local recovery groups (tuples of symbol indices)
  * checks   — parity-check vectors in *symbol space* (length-n uint8 rows
               h with h·y = 0) used to derive single-failure recovery plans.
               Minimal-support group checks come first.
  * block_type[i] ∈ {'d','l','g'} — data / local parity / global parity.

Host-side copy of `repro.core.codes` for the PyTorch port, plus
`code_from_state`, which rebuilds a `Code` from the plain values and
numpy arrays the reference's `Code` holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .gf import GF_EXP, gf_inv, gf_matmul, gf_pow


@dataclasses.dataclass(frozen=True)
class Code:
    name: str
    n: int
    k: int
    A: np.ndarray                      # (n-k, k) uint8
    groups: tuple[tuple[int, ...], ...]
    checks: np.ndarray                 # (num_checks, n) uint8
    block_type: tuple[str, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        assert self.A.shape == (self.n - self.k, self.k)
        assert self.checks.shape[1] == self.n
        assert len(self.block_type) == self.n

    @property
    def G(self) -> np.ndarray:
        """Full (n, k) systematic generator matrix."""
        return np.concatenate([np.eye(self.k, dtype=np.uint8), self.A], axis=0)

    @property
    def H(self) -> np.ndarray:
        """(n-k, n) parity check matrix [A | I] (char 2: -A = A)."""
        return np.concatenate(
            [self.A, np.eye(self.n - self.k, dtype=np.uint8)], axis=1)

    @property
    def num_local(self) -> int:
        return sum(1 for t in self.block_type if t == 'l')

    @property
    def num_global(self) -> int:
        return sum(1 for t in self.block_type if t == 'g')

    def group_of(self, i: int) -> int | None:
        for gi, grp in enumerate(self.groups):
            if i in grp:
                return gi
        return None

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, B) uint8 -> (n, B) codeword (host/oracle path)."""
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == self.k
        return np.concatenate([data, gf_matmul(self.A, data)], axis=0)


def code_from_state(name: str, n: int, k: int, A, groups, checks,
                    block_type, meta: dict | None = None) -> Code:
    """A `Code` from another process's or package's state, given as plain
    values and arrays: the fields of `repro.core.codes.Code`, in order.

    Arrays are copied into fresh uint8 arrays, so the result shares no
    memory with the caller's."""
    A = np.array(A, dtype=np.uint8)
    checks = np.array(checks, dtype=np.uint8)
    if A.shape != (n - k, k):
        raise ValueError(f"A is {A.shape}, expected {(n - k, k)}")
    if checks.ndim != 2 or checks.shape[1] != n:
        raise ValueError(f"checks is {checks.shape}, expected (*, {n})")
    block_type = tuple(str(t) for t in block_type)
    if len(block_type) != n or set(block_type) - {"d", "g", "l"}:
        raise ValueError("block_type needs n entries from 'd', 'g', 'l'")
    groups = tuple(tuple(int(b) for b in grp) for grp in groups)
    return Code(name=str(name), n=int(n), k=int(k), A=A, groups=groups,
                checks=checks, block_type=block_type,
                meta=dict(meta or {}))


# ---------------------------------------------------------------------------
# Element pools
# ---------------------------------------------------------------------------

def _distinct_elements(count: int) -> list[int]:
    """`count` distinct nonzero GF(2^8) elements (powers of the generator)."""
    if count > 255:
        raise ValueError(f"GF(2^8) supports at most 255 distinct nonzero "
                         f"elements; requested {count}")
    return [int(GF_EXP[j]) for j in range(count)]


def cauchy_matrix(rows: int, cols: int) -> np.ndarray:
    """(rows, cols) Cauchy matrix over GF(2^8): C[i,j] = 1/(x_i + y_j).

    Every square submatrix of a Cauchy matrix is invertible.
    """
    if rows + cols > 256:
        raise ValueError(f"Cauchy needs rows+cols <= 256, got {rows+cols}")
    x = np.arange(cols, rows + cols, dtype=np.uint8)   # rows' points
    y = np.arange(cols, dtype=np.uint8)                # cols' points
    denom = x[:, None] ^ y[None, :]
    return gf_inv(denom)


# ---------------------------------------------------------------------------
# UniLRC (paper §3.2)
# ---------------------------------------------------------------------------

def make_unilrc(alpha: int, z: int) -> Code:
    """UniLRC(n=αz²+z, k=αz²−αz, r=αz) — the paper's 4-step construction.

    Symbol order: [data | global parities g_1..g_{αz} | local parities
    l_1..l_z].  Group i (i ∈ [z]) = {data of group i} ∪ {g_{iα+1..(i+1)α}}
    ∪ {l_i}; each group maps onto one cluster (topology locality) and XORs
    to zero (XOR locality), giving every block locality r = αz
    (recovery locality, Thm 3.4) with d = r+2 (distance optimal, Thm 3.3).
    """
    if alpha < 1 or z < 2:
        raise ValueError("need alpha >= 1, z >= 2")
    k = alpha * z * (z - 1)
    g = alpha * z
    n = k + g + z
    r = alpha * z
    elems = _distinct_elements(k)

    # Step 1: Vandermonde part (rows g_j^1 .. g_j^{αz}); the split-off
    # all-ones row l is implicit in step 2.
    Gmat = np.zeros((g, k), dtype=np.uint8)
    for t in range(1, g + 1):
        for j in range(k):
            Gmat[t - 1, j] = gf_pow(elems[j], t)

    # Step 2: split the all-ones row into z disjoint groups (block diag L).
    group_data = k // z                       # α(z-1) data blocks per group
    L = np.zeros((z, k), dtype=np.uint8)
    for i in range(z):
        L[i, i * group_data:(i + 1) * group_data] = 1

    # Step 3: fold every α rows of G into G* (the group's global parities).
    Gstar = np.zeros((z, k), dtype=np.uint8)
    for i in range(z):
        acc = np.zeros(k, dtype=np.uint8)
        for gamma in range(alpha):
            acc ^= Gmat[i * alpha + gamma]
        Gstar[i] = acc

    # Step 4: couple local and global parities:  𝓛 = G* + L.
    Lmat = Gstar ^ L

    A = np.concatenate([Gmat, Lmat], axis=0)  # (g + z, k)

    # Groups and block types.
    block_type = ['d'] * k + ['g'] * g + ['l'] * z
    groups = []
    checks = []
    for i in range(z):
        data_idx = list(range(i * group_data, (i + 1) * group_data))
        glob_idx = list(range(k + i * alpha, k + (i + 1) * alpha))
        loc_idx = [k + g + i]
        grp = tuple(data_idx + glob_idx + loc_idx)
        groups.append(grp)
        # XOR check: sum of all group symbols = 0 (coefficient-1 everywhere)
        h = np.zeros(n, dtype=np.uint8)
        h[list(grp)] = 1
        checks.append(h)
    # Global rows as fallback checks (recover a global from all data).
    for t in range(g):
        h = np.zeros(n, dtype=np.uint8)
        h[:k] = Gmat[t]
        h[k + t] = 1
        checks.append(h)

    return Code(
        name=f"UniLRC({n},{k},{r})", n=n, k=k, A=A,
        groups=tuple(groups), checks=np.array(checks, dtype=np.uint8),
        block_type=tuple(block_type),
        meta=dict(family="unilrc", alpha=alpha, z=z, r=r, d=r + 2,
                  g=g, l=z, clusters=z))


# ---------------------------------------------------------------------------
# ALRC — Azure-LRC(k, l, g)  [Huang et al., ATC'12]
# ---------------------------------------------------------------------------

def make_alrc(k: int, l: int, g: int) -> Code:
    """Azure-LRC: l XOR local parities over k/l data each + g Cauchy globals.

    Symbol order: [data | globals | locals]. d = g + 2. Data/local blocks
    recover with k/l blocks; globals need all k data (paper Fig 1(a)).
    """
    if k % l != 0:
        raise ValueError("ALRC needs l | k")
    n = k + l + g
    gs = k // l
    Gmat = cauchy_matrix(g, k)
    L = np.zeros((l, k), dtype=np.uint8)
    for i in range(l):
        L[i, i * gs:(i + 1) * gs] = 1
    A = np.concatenate([Gmat, L], axis=0)
    block_type = ['d'] * k + ['g'] * g + ['l'] * l
    groups = []
    checks = []
    for i in range(l):
        grp = tuple(list(range(i * gs, (i + 1) * gs)) + [k + g + i])
        groups.append(grp)
        h = np.zeros(n, dtype=np.uint8)
        h[list(grp)] = 1
        checks.append(h)
    # globals form their own "group" (recovered from all k data)
    groups.append(tuple(list(range(k, k + g))))
    for t in range(g):
        h = np.zeros(n, dtype=np.uint8)
        h[:k] = Gmat[t]
        h[k + t] = 1
        checks.append(h)
    return Code(
        name=f"ALRC({n},{k},{{{gs},{k}}})", n=n, k=k, A=A,
        groups=tuple(groups), checks=np.array(checks, dtype=np.uint8),
        block_type=tuple(block_type),
        meta=dict(family="alrc", l=l, g=g, d=g + 2, r_data=gs))


# ---------------------------------------------------------------------------
# OLRC / ULRC — Google Cauchy LRCs  [Kadekodi et al., FAST'23]
# ---------------------------------------------------------------------------

def _cauchy_lrc(k: int, l: int, g: int, name: str, family: str,
                d_claim: int = 0) -> Code:
    """Shared construction: g Cauchy globals over data; the k data + g
    global blocks are split into l groups (as evenly as possible), each
    protected by one XOR local parity.

    Symbol order: [data | globals | locals]. Groups tile [data|globals] in
    index order, so with uneven sizes the first groups are data-heavy —
    exactly the Fig 2(b) normal-read imbalance the paper analyses.
    """
    n = k + g + l
    Gmat = cauchy_matrix(g, k)
    m = k + g                       # blocks to cover with local groups
    base, extra = divmod(m, l)
    # Larger groups last (paper Fig 1(c)/Fig 2: ULRC(42,30,{7,8}) has the
    # two 9-wide groups, which hold the globals, at the end).
    sizes = [base] * (l - extra) + [base + 1] * extra
    # Local parity rows, expressed over data coefficients: covering a global
    # parity block adds that global's Cauchy row into the local row.
    L = np.zeros((l, k), dtype=np.uint8)
    groups = []
    checks = []
    start = 0
    for i, sz in enumerate(sizes):
        members = list(range(start, start + sz))      # indices into [0, m)
        start += sz
        row = np.zeros(k, dtype=np.uint8)
        for b in members:
            if b < k:
                row[b] ^= 1
            else:
                row ^= Gmat[b - k]
        L[i] = row
        grp = tuple(members + [k + g + i])
        groups.append(grp)
        h = np.zeros(n, dtype=np.uint8)
        h[list(grp)] = 1
        checks.append(h)
    A = np.concatenate([Gmat, L], axis=0)
    block_type = ['d'] * k + ['g'] * g + ['l'] * l
    for t in range(g):
        h = np.zeros(n, dtype=np.uint8)
        h[:k] = Gmat[t]
        h[k + t] = 1
        checks.append(h)
    sizes_str = "{" + ",".join(str(s) for s in sorted(set(sizes))) + "}"
    return Code(
        name=f"{name}({n},{k},{sizes_str})", n=n, k=k, A=A,
        groups=tuple(groups), checks=np.array(checks, dtype=np.uint8),
        block_type=tuple(block_type),
        meta=dict(family=family, l=l, g=g, d=d_claim,
                  group_sizes=tuple(sizes)))


def make_olrc(k: int, l: int, g: int) -> Code:
    """Optimal Cauchy LRC: few, large local groups (condition g·l² < k+g·l),
    prioritising distance (d = g+2, distance optimal) over recovery locality
    (paper Limitation #1)."""
    if not g * l * l < k + g * l:
        raise ValueError(f"OLRC optimality condition g*l^2 < k+g*l violated "
                         f"for k={k}, l={l}, g={g}")
    return _cauchy_lrc(k, l, g, "OLRC", "olrc", d_claim=g + 2)


def make_ulrc(k: int, l: int, g: int) -> Code:
    """Uniform Cauchy LRC: approximately even local groups over data+globals
    — the Google deployment UniLRC compares against. Gives up one distance
    vs optimal (d = g+1, paper Table 1 "distance optimal: −") in exchange
    for near-uniform group sizes."""
    return _cauchy_lrc(k, l, g, "ULRC", "ulrc", d_claim=g + 1)


# ---------------------------------------------------------------------------
# Paper parameter sets (Table 2)
# ---------------------------------------------------------------------------

def make_rs(n: int, k: int) -> Code:
    """Plain MDS (Cauchy Reed-Solomon) — no locality: every recovery reads k."""
    g = n - k
    Gmat = cauchy_matrix(g, k)
    block_type = ['d'] * k + ['g'] * g
    checks = []
    for t in range(g):
        h = np.zeros(n, dtype=np.uint8)
        h[:k] = Gmat[t]
        h[k + t] = 1
        checks.append(h)
    return Code(
        name=f"RS({n},{k})", n=n, k=k, A=Gmat,
        groups=(tuple(range(n)),), checks=np.array(checks, dtype=np.uint8),
        block_type=tuple(block_type), meta=dict(family="rs", d=n - k + 1))


def paper_schemes(scheme: str) -> dict[str, Code]:
    """The paper's three comparison points: 30-of-42, 112-of-136, 180-of-210.

    ALRC/ULRC sized so d = f+1 matches Table 2's fault tolerance f; OLRC
    uses the largest l satisfying its optimality condition (l=2).
    """
    if scheme == "30-of-42":
        return {
            "ALRC": make_alrc(k=30, l=6, g=6),
            "OLRC": make_olrc(k=30, l=2, g=10),
            "ULRC": make_ulrc(k=30, l=5, g=7),
            "UniLRC": make_unilrc(alpha=1, z=6),
        }
    if scheme == "112-of-136":
        return {
            "ALRC": make_alrc(k=112, l=8, g=16),
            "OLRC": make_olrc(k=112, l=2, g=22),
            "ULRC": make_ulrc(k=112, l=7, g=17),
            "UniLRC": make_unilrc(alpha=2, z=8),
        }
    if scheme == "180-of-210":
        return {
            "ALRC": make_alrc(k=180, l=10, g=20),
            "OLRC": make_olrc(k=180, l=2, g=28),
            "ULRC": make_ulrc(k=180, l=9, g=21),
            "UniLRC": make_unilrc(alpha=2, z=10),
        }
    raise KeyError(scheme)


ALL_SCHEMES = ("30-of-42", "112-of-136", "180-of-210")
