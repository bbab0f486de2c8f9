"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Byte equality for the coding kernels (GF(2^8) coding is exact);
attention within 2e-2 in bf16 and 2e-5 (out) / 1e-4 (lse) in fp32.

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
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import gf_bitmatmul as gfk
from repro_torch.kernels import xor_reduce as xrk
from repro_torch.models import (ModelConfig, forward, init_params,
                                pad_cache_to, params_from_jax, params_to_tree,
                                uniform_segments)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bytes(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


GF_CASES = [
    (1, 1, 1, 1, "random", 0), (3, 1, 20, 3000, "random", 0),
    (2, 21, 180, 4096, "random", 0), (8, 30, 180, 65536, "random", 0),
    (2, 17, 33, 1000, "random", 0), (1, 40, 9, 160, "random", 0),
    # the encode code: N = 240, the 1,440 bit columns in two passes
    (2, 30, 180, 4096, "encode", 0),
    # the cluster-decode plan: N padded from 168 to 176, two passes
    (2, 21, 180, 4096, "cluster", 0),
    # delta terms over four and two N tiles
    (1, 105, 5, 4096, "random", 0), (1, 42, 2, 4096, "random", 0),
    # one output row; K padded from 8 to 32 bit columns
    (2, 1, 20, 4096, "random", 0), (2, 1, 1, 1000, "random", 0),
    # a ragged width and an unaligned base take the wrapper's aligned copy
    (2, 30, 180, 4097, "encode", 0), (2, 30, 180, 4097, "encode", 1),
    # the serve save's batch of 36 stripes
    (36, 30, 180, 256, "encode", 0),
]


def _matrix(kind, m, k):
    if kind == "random":
        return _bytes(m * k, (m, k)).numpy()
    code = make_unilrc(2, 10)
    M = code.A if kind == "encode" else \
        decode_plan(code, code.groups[0]).M
    assert M.shape == (m, k)
    return M


@pytest.mark.parametrize("S,m,k,B,kind,offset", GF_CASES)
def test_gf_matches_plain(card, S, m, k, B, kind, offset):
    cols = torch.from_numpy(gf_bit_columns(_matrix(kind, m, k)))
    flat = _bytes(B, (S * k * B + offset,))
    data = flat[offset:].view(S, k, B)
    got = gfk.gf_bitmatmul(cols.to(card), flat.to(card)[offset:].view(S, k, B))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gfk.gf_bitmatmul_plain(cols, data))


def test_gf_call_is_one_launch_of_the_tensor_core_kernel(card):
    """One call on aligned data counts one launch, runs one device kernel
    and it is `gf_matmul_sm90_kernel`."""
    from torch.profiler import ProfilerActivity, profile
    cols = torch.from_numpy(gf_bit_columns(_matrix("encode", 30, 180)))
    data = _bytes(7, (2, 180, 4096)).to(card)
    cols = cols.to(card)
    gfk.gf_bitmatmul(cols, data)                       # built and warm
    torch.cuda.synchronize()
    before = (gfk.launches, gfk.plain_calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gfk.gf_bitmatmul(cols, data)
        torch.cuda.synchronize()
    assert (gfk.launches, gfk.plain_calls) == (before[0] + 1, before[1])
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memset" not in e.name.lower()
               and "memcpy" not in e.name.lower()]
    assert len(kernels) == 1 and "gf_matmul_sm90_kernel" in kernels[0], \
        kernels


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


# causal, window, B, Hq, Hkv, Sq, Skv, d, dtype
FLASH_CASES = [
    (True, 0, 1, 4, 1, 1000, 1000, 128, torch.bfloat16),   # ragged, G=4
    (True, 512, 2, 8, 2, 2048, 2048, 128, torch.bfloat16),  # window
    (False, 0, 1, 2, 2, 100, 333, 64, torch.bfloat16),     # Sq != Skv
    (True, 0, 2, 8, 2, 1, 1, 128, torch.bfloat16),         # one token
    (True, 0, 1, 2, 1, 256, 256, 128, torch.float32),
    (True, 128, 1, 4, 2, 300, 300, 64, torch.float32),     # window, ragged
    # the bf16 kernel's tile edges: 128 query rows a CTA, 128-key tiles
    (True, 0, 1, 4, 1, 127, 127, 128, torch.bfloat16),
    (True, 0, 1, 4, 1, 128, 128, 128, torch.bfloat16),
    (True, 0, 1, 4, 1, 129, 129, 128, torch.bfloat16),
    (True, 0, 1, 4, 1, 129, 129, 64, torch.bfloat16),
    (False, 0, 2, 4, 4, 129, 129, 128, torch.bfloat16),    # G=1
    (True, 0, 1, 16, 2, 300, 300, 128, torch.bfloat16),    # G=8
    (True, 200, 1, 4, 2, 700, 700, 128, torch.bfloat16),   # window over tiles
    (True, 0, 1, 2, 1, 4096, 4096, 128, torch.bfloat16),   # the ring wraps 16x
    # non-causal window past the keys: rows (and, at Sq=400, whole q
    # tiles) that see no key write out = 0 and lse = -inf
    (False, 4, 1, 2, 1, 40, 8, 64, torch.bfloat16),
    (False, 4, 1, 2, 1, 400, 8, 128, torch.bfloat16),
    # head dim 256 (recurrentgemma's local attention, MQA): the serve
    # shape, then the 64-key tile's edges, the 128-row q tile's edges, a
    # window narrower than a key tile, Sq != Skv, one token, dead rows
    (True, 2048, 2, 16, 1, 3968, 3968, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 63, 63, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 64, 64, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 65, 65, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 127, 127, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 128, 128, 256, torch.bfloat16),
    (True, 0, 1, 4, 1, 129, 129, 256, torch.bfloat16),
    (True, 40, 1, 16, 1, 300, 300, 256, torch.bfloat16),
    (False, 0, 1, 4, 2, 100, 333, 256, torch.bfloat16),
    (True, 0, 2, 16, 1, 1, 1, 256, torch.bfloat16),
    (False, 4, 1, 2, 1, 400, 8, 256, torch.bfloat16),
]


def _qkv(seed, B, Hq, Hkv, Sq, Skv, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
            for sh in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]


@pytest.mark.parametrize("causal,window,B,Hq,Hkv,Sq,Skv,d,dtype",
                         FLASH_CASES)
def test_flash_matches_plain(card, causal, window, B, Hq, Hkv, Sq, Skv, d,
                             dtype):
    q, k, v = (t.to(card) for t in _qkv(Sq, B, Hq, Hkv, Sq, Skv, d, dtype))
    out, lse = fak.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=window)
    torch.cuda.synchronize()
    tol, lse_tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-5, 1e-4)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - want.float()).abs().max().item() <= tol
    # rows that see no key: lse is -inf in both, and nowhere else
    dead = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert (lse - want_lse)[~dead].abs().max().item() <= lse_tol


@pytest.mark.parametrize("d,dtype,item", [
    (96, torch.bfloat16, "ROADMAP C1"),     # no kernel; the layer routes it
    (384, torch.bfloat16, "ROADMAP C1"),    # a multiple of 128, no kernel
    (256, torch.float32, "ROADMAP B6"),     # the fp32 kernel stops at 128
])
def test_flash_head_dim_outside_the_kernel_raises(card, d, dtype, item):
    q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, 64, 64, d, dtype))
    fak.reset_counts()
    with pytest.raises(NotImplementedError, match=item):
        fak.flash_attention_fwd(q, k, v)
    assert (fak.launches, fak.plain_calls) == (0, 0)


def test_flash_counts_launches_only_on_the_card(card):
    fak.reset_counts()
    q, k, v = (t.to(card) for t in _qkv(0, 1, 2, 1, 64, 64, 64,
                                        torch.bfloat16))
    fak.flash_attention_fwd(q, k, v)
    assert (fak.launches, fak.fp32_launches, fak.plain_calls) == (1, 0, 0)


def test_fp32_flash_counts_its_own_launches(card):
    """An fp32 call launches the scalar `flash_fwd_kernel`: it counts in
    `launches` and in `fp32_launches`, and its result is the plain
    version's."""
    q, k, v = (t.to(card) for t in _qkv(3, 1, 4, 2, 200, 200, 128,
                                        torch.float32))
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fak.launches, fak.fp32_launches, fak.plain_calls) == (1, 1, 0)
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v)
    assert (out - want).abs().max().item() <= 2e-5
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_bf16_flash_is_one_launch_of_the_hopper_kernel(card):
    """A bf16 call at the serving head dim counts one launch and no plain
    call, and its result is the plain version's."""
    q, k, v = (t.to(card) for t in _qkv(1, 2, 8, 2, 300, 300, 128,
                                        torch.bfloat16))
    fak.reset_counts()
    out, lse = fak.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls) == (1, 0)
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 2e-2


def test_smoke_model_on_the_card_matches_the_cpu(card):
    """A 2-layer model with head dim 64 (ghost heads 6 -> 8) on the card
    against the same weights on the CPU: logits within 5e-2 of max |logit|
    (bf16 matmuls round in other places on the two devices)."""
    cfg = ModelConfig(name="cuda-smoke", family="dense", d_model=384,
                      num_heads=6, num_kv_heads=2, d_ff=512, vocab_size=512,
                      segments=uniform_segments("attn", 2),
                      rope_theta=10000.0, tie_embeddings=True, tp_pad_heads=4)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (2, 100)))
    fak.reset_counts()
    got, _, _ = forward(dev, tokens.to(card), mode="train")
    assert (fak.launches, fak.plain_calls) == (2, 0)
    want, _, _ = forward(host, tokens, mode="train")
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale

    _, cache, _ = forward(dev, tokens[:, :99].to(card), mode="prefill")
    cache = pad_cache_to(cache, cfg, 104)
    step, _, _ = forward(dev, tokens[:, 99:].to(card), mode="decode",
                         cache=cache, pos=99)
    assert (step[:, 0].cpu().float() - want[:, -1].float()).abs().max() \
        .item() < 5e-2 * scale


@pytest.mark.parametrize("head_dim", [16, 256])
def test_recurrentgemma_smoke_on_the_card_matches_the_cpu(card, head_dim):
    """recurrentgemma SMOKE (rg, rg, local_attn, rg, rg; window 8) on the
    card against the same weights on the CPU, 40 tokens: train logits, and
    prefill + decode steps past the window, within 5e-2 of max |logit|.
    At head dim 16 the local attention runs blockwise; at 256 it launches
    the flash kernel, once per prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, layers

    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              head_dim=head_dim)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = params_from_jax(cfg, params_to_tree(host), card)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 40)))
    fak.reset_counts()
    layers.reset_blockwise_calls()
    got, _, _ = forward(dev, tokens.to(card), mode="train")
    want, _, _ = forward(host, tokens, mode="train")
    kernel = head_dim == 256
    assert (fak.launches, layers.blockwise_calls) == \
        ((1, 0) if kernel else (0, 2))      # host: blockwise at 16
    scale = want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() < 5e-2 * scale

    # prefill 30, then 10 decode steps (past the window of 8) on the card
    _, cache, _ = forward(dev, tokens[:, :30].to(card), mode="prefill")
    cache = pad_cache_to(cache, cfg, 40)
    for i in range(30, 40):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
        assert (step[:, 0].cpu().float() - want[:, i].float()).abs().max() \
            .item() < 5e-2 * scale
    # and from a zeroed cache on the card, token by token
    cache = init_cache(cfg, 2, 40, device=card)
    for i in range(12):
        step, cache, _ = forward(dev, tokens[:, i:i + 1].to(card),
                                 mode="decode", cache=cache, pos=i)
    assert (step[:, 0].cpu().float() - want[:, 11].float()).abs().max() \
        .item() < 5e-2 * scale


@pytest.mark.parametrize("d", [16, 80])
def test_layer_off_the_kernel_head_dims_on_the_card(card, d):
    """A head dim the flash kernel lacks goes through the layer on the card
    blockwise (no launch, no raise) and matches the kernel's plain version
    on the CPU within the bf16 tolerance of FLASH_CASES."""
    from repro_torch.models import layers

    q, k, v = _qkv(d, 2, 8, 2, 300, 300, d, torch.bfloat16)
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = layers.flash_attention(q.to(card), k.to(card), v.to(card),
                                 causal=True)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == \
        (0, 0, 1)
    want, _ = fak.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.cpu().float() - want.float()).abs().max().item() <= 2e-2


def test_layer_head_dim_256_on_the_card_launches_the_kernel(card):
    """dk = dv = 256 is a multiple of 128, which the reference hands its
    Pallas kernel: the layer hands it to the flash wrapper, which launches
    the Hopper kernel once (no blockwise call, no plain call), windowed as
    recurrentgemma's local attention is."""
    from repro_torch.models import layers

    q, k, v = (t.to(card) for t in _qkv(0, 1, 4, 1, 300, 300, 256,
                                        torch.bfloat16))
    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = layers.flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == \
        (1, 0, 0)
    want, _ = fak.flash_attention_fwd_plain(q, k, v, causal=True, window=100)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2


def test_serve_smoke_arch_on_the_card(card):
    """`python -m repro_torch.launch.serve --arch llama3.2-3b` on the card:
    the SMOKE config (head dim 16) serves blockwise, with no flash launch."""
    from repro_torch.launch import serve
    from repro_torch.models import layers

    fak.reset_counts()
    layers.reset_blockwise_calls()
    out = serve.run(["--arch", "llama3.2-3b", "--requests", "1",
                     "--prompt-len", "8", "--gen", "2"])
    assert [tuple(t.shape) for t in out["tokens"]] == [(1, 2)]
    assert (fak.launches, fak.plain_calls) == (0, 0)
    assert layers.blockwise_calls >= 1


def test_lifetime_sampler_on_the_card(card):
    """The simulator's initial lifetimes drawn on the card: equal per
    generator seed, float64 on the host, and the sample mean within 3
    standard errors of the hazard's mean."""
    from repro_torch.sim import Weibull, exponential_from_mttf_years
    from repro_torch.sim import sample_lifetimes

    def draw(hazard, seed, shape):
        gen = torch.Generator(device=card)
        gen.manual_seed(seed)
        return sample_lifetimes(hazard, gen, shape, device=card)

    for hazard in (exponential_from_mttf_years(0.5),
                   Weibull(shape=0.7, scale=4000.0)):
        a, b = draw(hazard, 7, (400, 240)), draw(hazard, 7, (400, 240))
        assert a.shape == (400, 240) and a.dtype == np.float64
        assert np.array_equal(a, b)
        assert not np.array_equal(a, draw(hazard, 8, (400, 240)))
        x = draw(hazard, 1, (200_000,))
        se = x.std(ddof=1) / np.sqrt(x.size)
        assert abs(x.mean() - hazard.mean_hours) < 3 * se


def test_data_path_trial_on_the_card(card):
    """A data-path `DssTrial` on the card: churn with real repairs through
    the coding kernels, every launch one plan group, no plain version, and
    the payload read back byte for byte."""
    from repro_torch.core import MTTDLParams
    from repro_torch.kernels import ops
    from repro_torch.sim import DssTrial, SimConfig, sample_lifetimes

    params = MTTDLParams(N=4, S_TB=1.0, epsilon=0.5, delta=0.5,
                         T_hours=48.0, B_Gbps=1.0, node_mttf_years=0.5)
    cfg = SimConfig(code=make_unilrc(1, 4), params=params, n_stripes=6,
                    trials=1, seed=3, mission_hours=2000.0, data_path=True,
                    block_size=4096, device="cuda")
    nodes = cfg.resolved_placement().num_clusters * cfg.resolved_npc()
    gen = torch.Generator(device=card)
    gen.manual_seed(cfg.seed)
    init = sample_lifetimes(cfg.resolved_failure_model().node, gen,
                            (1, nodes), device=card)
    gfk.reset_counts()
    xrk.reset_counts()
    trial = DssTrial(cfg, 0, init[0])
    assert trial.codec.backend.device.type == "cuda"
    before = sum(ops.KERNEL_LAUNCHES.values())
    res = trial.run()
    ledger = trial.scheduler.ledger
    assert not res.lost and res.repaired_blocks > 0
    assert ledger.kernel_launches == ledger.plan_groups > 0
    assert sum(ops.KERNEL_LAUNCHES.values()) - before == ledger.kernel_launches
    assert xrk.launches > 0
    assert gfk.plain_calls == xrk.plain_calls == 0
    assert trial.codec.read_all(trial.metas) == trial.payload
