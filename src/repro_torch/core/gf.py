"""GF(2^8) arithmetic — the coding field of UniLRC (paper §3.2, §4.2).

The paper codes over GF(2^8) (byte granularity, ISA-L compatible). We use
the standard primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D), the
same one ISA-L / Rijndael-style EC libraries use, with generator alpha = 2.

Two representations are provided:

* **Table form** (numpy, host side): exp/log tables for scalar and matrix
  algebra — generator-matrix construction, Gaussian elimination for decode
  matrices. These run at failure/setup time on tiny (n-k)^2 matrices.
* **Bit-matrix form**: multiplication by a constant c is GF(2)-linear, i.e.
  an 8x8 binary matrix M_c with bit_out = M_c @ bit_in (mod 2). Column i
  of M_c is the byte c * 2^i (`gf_bit_columns`); the CUDA coding kernel
  (kernels/gf_bitmatmul.py) XORs those columns under the data's bit masks.

Host-side copy of `repro.core.gf` for the PyTorch port: the same tables
and the same functions, so the port imports nothing of the reference.
"""
from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1 (primitive)
GF_ORDER = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]  # wraparound so exp[(la+lb)] needs no mod
    log[0] = -1  # sentinel; log(0) undefined
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# Full 256x256 multiplication table — used by the reference (oracle) path
# and by table-based encode. 64KB, built once.
_a = np.arange(256, dtype=np.int64)
_MUL = np.zeros((256, 256), dtype=np.uint8)
_nz = _a[1:]
_MUL[1:, 1:] = GF_EXP[(GF_LOG[_nz][:, None] + GF_LOG[_nz][None, :]) % 255]
GF_MUL_TABLE = _MUL


def gf_mul(a, b):
    """Elementwise GF(2^8) multiply of uint8 arrays (numpy, table-based)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return GF_MUL_TABLE[a, b]


def gf_inv(a):
    """Elementwise multiplicative inverse (a != 0)."""
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    return GF_EXP[(255 - GF_LOG[a]) % 255].astype(np.uint8)


def gf_pow(a: int, e: int) -> int:
    """Scalar power a**e in GF(2^8)."""
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * e) % 255])


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of uint8 matrices (host/oracle path).

    XOR-accumulate of table products. O(m*k*n) byte ops — used for small
    coding matrices and as the host oracle for the coding kernels.
    """
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    assert A.shape[-1] == B.shape[0], (A.shape, B.shape)
    out = np.zeros((A.shape[0], *B.shape[1:]), dtype=np.uint8)
    for j in range(A.shape[1]):
        prod = GF_MUL_TABLE[A[:, j][:, None], B[j][None, ...].reshape(1, -1)]
        out ^= prod.reshape(A.shape[0], *B.shape[1:])
    return out


def gf_matvec(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    return gf_matmul(A, x.reshape(-1, 1)).reshape(-1)


def gf_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve A X = B over GF(2^8) via Gaussian elimination (A square,
    invertible). Raises np.linalg.LinAlgError if singular."""
    A = np.array(A, dtype=np.uint8)
    B = np.array(B, dtype=np.uint8)
    n = A.shape[0]
    assert A.shape == (n, n)
    if B.ndim == 1:
        B = B.reshape(n, 1)
        squeeze = True
    else:
        squeeze = False
    M = np.concatenate([A, B], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(M[col:, col] != 0))
        if M[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF matrix")
        if piv != col:
            M[[col, piv]] = M[[piv, col]]
        inv = gf_inv(M[col, col])
        M[col] = GF_MUL_TABLE[inv, M[col]]
        mask = (M[:, col] != 0)
        mask[col] = False
        if mask.any():
            factors = M[mask, col]
            M[mask] ^= GF_MUL_TABLE[factors[:, None], M[col][None, :]]
    X = M[:, n:]
    return X.reshape(-1) if squeeze else X


def gf_rank(A: np.ndarray) -> int:
    """Rank of a GF(2^8) matrix."""
    M = np.array(A, dtype=np.uint8)
    rows, cols = M.shape
    rank = 0
    for col in range(cols):
        piv = None
        for rr in range(rank, rows):
            if M[rr, col] != 0:
                piv = rr
                break
        if piv is None:
            continue
        M[[rank, piv]] = M[[piv, rank]]
        inv = gf_inv(M[rank, col])
        M[rank] = GF_MUL_TABLE[inv, M[rank]]
        mask = M[:, col] != 0
        mask[rank] = False
        if mask.any():
            M[mask] ^= GF_MUL_TABLE[M[mask, col][:, None], M[rank][None, :]]
        rank += 1
        if rank == rows:
            break
    return rank


def gf_inv_matrix(A: np.ndarray) -> np.ndarray:
    n = A.shape[0]
    return gf_solve(A, np.eye(n, dtype=np.uint8))


# ---------------------------------------------------------------------------
# Bit-matrix form: GF(2^8) constant-multiplication as an 8x8 GF(2) matrix.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _bitmatrix_table() -> np.ndarray:
    """(256, 8, 8) uint8 in {0,1}: T[c][o, i] = bit o of (c * 2^i).

    Column i of M_c is c * x^i reduced mod the field polynomial, so
    byte_out = XOR_i bit_in[i] * (c * 2^i)  =>  bits_out = M_c @ bits_in.
    Bit order: LSB-first (bit 0 = 1s place).
    """
    T = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        for i in range(8):
            prod = gf_mul(np.uint8(c), np.uint8(1 << i))
            for o in range(8):
                T[c, o, i] = (int(prod) >> o) & 1
    return T


def gf_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication by constant c (LSB-first bits)."""
    return _bitmatrix_table()[c]


def expand_coding_matrix_to_bits(A: np.ndarray) -> np.ndarray:
    """Expand an (m, k) GF(2^8) coding matrix into an (8m, 8k) binary matrix.

    parity_bits = (A_bits @ data_bits) mod 2 where data bytes are unpacked
    LSB-first into 8 bit-planes: row 8i+o, column 8j+b is bit o of
    A[i, j] * 2^b.
    """
    A = np.asarray(A, dtype=np.uint8)
    m, k = A.shape
    T = _bitmatrix_table()
    # (m, k, 8, 8) -> (m, 8, k, 8) -> (8m, 8k)
    bits = T[A]                      # (m, k, 8, 8) [out_bit, in_bit]
    bits = bits.transpose(0, 2, 1, 3).reshape(8 * m, 8 * k)
    return bits.astype(np.uint8)


def gf_bit_columns(A: np.ndarray) -> np.ndarray:
    """(m, k) coefficients -> (m, k, 8) uint8 with [i, j, b] = A[i, j] * 2^b.

    The same information as `expand_coding_matrix_to_bits`, packed one
    byte per bit column: A[i, j] * x = XOR over the set bits b of x of
    [i, j, b]. This is the coefficient operand of the CUDA kernel."""
    A = np.asarray(A, dtype=np.uint8)
    powers = (1 << np.arange(8)).astype(np.uint8)
    return GF_MUL_TABLE[A[:, :, None], powers[None, None, :]]


def bytes_to_bitplanes(data: np.ndarray) -> np.ndarray:
    """(k, B) uint8 -> (8k, B) {0,1} uint8, LSB-first per byte row."""
    data = np.asarray(data, dtype=np.uint8)
    k, B = data.shape
    shifts = np.arange(8, dtype=np.uint8)
    planes = (data[:, None, :] >> shifts[None, :, None]) & 1
    return planes.reshape(8 * k, B)


def bitplanes_to_bytes(planes: np.ndarray) -> np.ndarray:
    """(8m, B) {0,1} -> (m, B) uint8, inverse of bytes_to_bitplanes."""
    planes = np.asarray(planes, dtype=np.uint8)
    m8, B = planes.shape
    assert m8 % 8 == 0
    planes = planes.reshape(m8 // 8, 8, B)
    weights = (1 << np.arange(8, dtype=np.uint16))
    return (planes.astype(np.uint16) * weights[None, :, None]).sum(axis=1).astype(np.uint8)
