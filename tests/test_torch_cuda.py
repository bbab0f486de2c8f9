"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Byte equality: GF(2^8) coding is exact.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports nothing of the reference package, so it runs on a machine without
jax:  python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import make_unilrc
from repro_torch.core.codec import decode_plan
from repro_torch.core.gf import gf_bit_columns
from repro_torch.kernels import gf_bitmatmul as gfk
from repro_torch.kernels import xor_reduce as xrk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bytes(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("S,m,k,B", [(1, 1, 1, 1), (3, 1, 20, 3000),
                                     (2, 21, 180, 4096), (8, 30, 180, 65536),
                                     (2, 17, 33, 1000), (1, 40, 9, 160)])
def test_gf_matches_plain(card, S, m, k, B):
    cols = torch.from_numpy(gf_bit_columns(_bytes(m * k, (m, k)).numpy()))
    data = _bytes(B, (S, k, B))
    got = gfk.gf_bitmatmul(cols.to(card), data.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gfk.gf_bitmatmul_plain(cols, data))


def test_gf_unaligned_view_and_decode_matrix(card):
    code = make_unilrc(2, 10)
    plan = decode_plan(code, code.groups[0])          # a lost cluster
    assert plan.M.shape[0] == 21
    cols = torch.from_numpy(gf_bit_columns(plan.M))
    k = plan.M.shape[1]
    flat = _bytes(1, (2 * k * 2048 + 1,))
    view = flat[1:].view(2, k, 2048)                  # 1-byte offset base
    got = gfk.gf_bitmatmul(cols.to(card), flat.to(card)[1:].view(2, k, 2048))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gfk.gf_bitmatmul_plain(cols, view))


@pytest.mark.parametrize("S,s,B", [(1, 1, 5), (1, 2, 3000), (23, 20, 65536),
                                   (4, 29, 4097)])
def test_xor_matches_plain(card, S, s, B):
    blocks = _bytes(s * B, (S, s, B))
    got = xrk.xor_reduce(blocks.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), xrk.xor_reduce_plain(blocks))


def test_wrappers_count_launches_only_on_the_card(card):
    gfk.reset_counts()
    xrk.reset_counts()
    x = _bytes(0, (1, 3, 64)).to(card)
    xrk.xor_reduce(x)
    gfk.gf_bitmatmul(torch.ones((1, 3, 8), dtype=torch.uint8, device=card), x)
    assert (xrk.launches, xrk.plain_calls) == (1, 0)
    assert (gfk.launches, gfk.plain_calls) == (1, 0)
