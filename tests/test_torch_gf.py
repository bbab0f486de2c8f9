"""`repro_torch.core.gf`'s `gf_matvec`, `gf_inv_matrix` and `gf_bitmatrix`
against `repro.core.gf`'s, byte for byte, on inputs from numpy seeds."""
import numpy as np
import pytest

from repro.core import gf as ref_gf
from repro_torch.core import gf


@pytest.mark.parametrize("m,k,seed", [(1, 1, 0), (6, 4, 1), (30, 180, 2),
                                      (21, 180, 3)])
def test_gf_matvec(m, k, seed):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 256, (m, k), dtype=np.uint8)
    x = rng.integers(0, 256, k, dtype=np.uint8)
    got = gf.gf_matvec(A, x)
    assert got.dtype == np.uint8 and got.shape == (m,)
    assert np.array_equal(got, ref_gf.gf_matvec(A, x))


@pytest.mark.parametrize("n,seed", [(1, 0), (4, 1), (12, 2), (30, 3)])
def test_gf_inv_matrix(n, seed):
    rng = np.random.default_rng(seed)
    while True:         # a random invertible matrix
        A = rng.integers(0, 256, (n, n), dtype=np.uint8)
        if gf.gf_rank(A) == n:
            break
    inv = gf.gf_inv_matrix(A)
    assert np.array_equal(inv, ref_gf.gf_inv_matrix(A))
    assert np.array_equal(gf.gf_matmul(A, inv), np.eye(n, dtype=np.uint8))


def test_gf_inv_matrix_raises_on_a_singular_matrix():
    A = np.array([[1, 2], [2, 4]], dtype=np.uint8)   # row 2 = 2 * row 1
    with pytest.raises(np.linalg.LinAlgError):
        gf.gf_inv_matrix(A)
    with pytest.raises(np.linalg.LinAlgError):
        ref_gf.gf_inv_matrix(A)


def test_gf_bitmatrix_every_constant():
    for c in range(256):
        got = gf.gf_bitmatrix(c)
        assert got.shape == (8, 8) and got.dtype == np.uint8
        assert np.array_equal(got, ref_gf.gf_bitmatrix(c))
    # multiplying by c is the bit matrix acting on x's bits (LSB first)
    x = 0xB7
    bits = (x >> np.arange(8)) & 1
    for c in (0, 1, 2, 0x1D, 0xFF):
        prod = (gf.gf_bitmatrix(c).astype(int) @ bits) % 2
        assert int((prod << np.arange(8)).sum()) == int(gf.gf_mul(c, x))
