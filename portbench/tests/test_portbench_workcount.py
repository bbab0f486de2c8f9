"""Every work count of the benchmark against a count made by hand, and the
per-layer readers on readings written out by hand."""
from __future__ import annotations

import pytest
from portbench_cases import ROOT  # noqa: F401  (puts the checkout on the path)

from portbench import spec, workcount
from portbench.blocks import attn_moe, mla
from portbench.harness import Readings

MINICPM = spec._json(spec.HERE / "configs" / "minicpm3-4b.json")
PHI = spec._json(spec.HERE / "configs" / "phi3.5-moe-16l.json")


def test_causal_pairs_by_hand():
    assert workcount.causal_pairs(4, 4) == 4 + 3 + 2 + 1
    assert workcount.causal_pairs(2048, 2048) == 2048 * 2049 // 2
    assert workcount.causal_pairs(2, 5) == 4 + 5          # the last 2 rows
    assert workcount.causal_pairs(1, 7) == 7


def test_matmul_weights_by_hand():
    # q_a, q_b, kv_a, kv_b, o, gate + up + down
    assert mla.matmul_weights(MINICPM["config"]) == (
        2560 * 768 + 768 * 40 * 96 + 2560 * 288 + 256 * 40 * 128
        + 40 * 64 * 2560 + 3 * 2560 * 6400) == 62_668_800
    # q, k + v, o, router, 2 experts of gate + up + down
    assert attn_moe.matmul_weights(PHI["config"]) == (
        4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096 + 4096 * 16
        + 2 * 3 * 4096 * 6400) == 199_294_976


def test_attention_dims_are_the_published_ones():
    # MLA's non-absorbed form: 40 heads, each with its key (64 + 32) and
    # value (64); phi: 32 query heads over 8 kv heads of 128
    assert mla.attention_dims(MINICPM["config"]) == (40, 40, 96, 64)
    assert attn_moe.attention_dims(PHI["config"]) == (32, 8, 128, 128)


def test_prefill_flops_by_hand():
    pairs = 2048 * 2049 // 2
    # minicpm3: 62 layers of matmuls over 8,192 tokens, attention at 96 /
    # 64 over 40 heads, the head at 4 last positions
    assert workcount.prefill_flops("mla", MINICPM["config"], 62, 4, 2048) == (
        62 * (2 * 62_668_800 * 8192 + 4 * 40 * pairs * 2 * (96 + 64))
        + 2 * 2560 * 73448 * 4)
    assert workcount.prefill_flops("attn_moe", PHI["config"], 16, 4, 2048) == (
        16 * (2 * 199_294_976 * 8192 + 4 * 32 * pairs * 2 * (128 + 128))
        + 2 * 4096 * 32064 * 4)


def test_attention_bound_by_hand():
    # minicpm3's attention as published: 40 heads, dk 96, dv 64, each
    # head's key and value its own
    flops = workcount.attention_flops(4, 40, 2048, 2048, 96, 64)
    assert flops == 4 * 40 * (2048 * 2049 // 2) * 2 * 160
    nbytes = workcount.attention_bytes(4, 40, 40, 2048, 2048, 96, 64)
    assert nbytes == 2 * (4 * 40 * 2048 * 160 + 4 * 40 * 2048 * 160)
    assert workcount.least_seconds(flops, nbytes) == flops / 989e12
    assert workcount.least_seconds(10, 10 ** 9) == 10 ** 9 / 3.35e12
    assert flops / 989e12 == pytest.approx(1.086e-4, rel=0.01)


def _readings(**kw) -> Readings:
    base = dict(config=MINICPM, traffic={"batch": 4, "prompt_len": 2048},
                batches=2, window_s=4.0, prefill_ms=[1900.0, 2100.0],
                calls={}, profile={})
    return Readings(**{**base, **kw})


def test_readers_by_hand():
    read = {m: spec.reader(m).read for m in (
        "mfu.prefill", "attention_share.prefill", "attention_roofline.prefill",
        "moe_share.prefill", "device_idle.prefill")}
    r = _readings()
    flops = workcount.prefill_flops("mla", MINICPM["config"], 62, 4, 2048)
    assert read["mfu.prefill"](r) == pytest.approx(
        100 * 2 * flops / 4.0 / 989e12)
    # no calls, no profile: nothing to read, and not 0
    for m in ("attention_share.prefill", "attention_roofline.prefill",
              "moe_share.prefill", "device_idle.prefill"):
        assert read[m](r) is None
    # the port's absorbed call (48 padded heads, dk 288, dv 256, one kv
    # head) is counted at the published widths: only its batch, lengths
    # and causality are read
    shapes = [(4, 48, 2048, 288), (4, 1, 2048, 288), (4, 1, 2048, 256)]
    call = (25.0, shapes, {"causal": True})
    r = _readings(calls={"attention": [call, call], "moe": [(500.0, [], {})]},
                  profile={"busy_s": 3.0, "window_s": 4.0})
    assert read["attention_share.prefill"](r) == pytest.approx(100 * 50 / 4000)
    bound = 4 * 40 * (2048 * 2049 // 2) * 2 * 160 / 989e12
    assert read["attention_roofline.prefill"](r) == pytest.approx(
        100 * bound / 0.025)
    # phi's call is the published GQA; bytes rule at a short prompt
    r_phi = _readings(config=PHI, calls={"attention": [(0.5, [
        (1, 32, 16, 128), (1, 8, 16, 128), (1, 8, 16, 128)], {})]})
    nbytes = 2 * (32 * 16 * 256 + 8 * 16 * 256)
    assert read["attention_roofline.prefill"](r_phi) == pytest.approx(
        100 * nbytes / 3.35e12 / 5e-4)
    assert read["moe_share.prefill"](r) == pytest.approx(100 * 500 / 4000)
    assert read["device_idle.prefill"](r) == pytest.approx(25.0)


def test_routing_load_by_hand():
    import torch
    c = {"num_local_experts": 4, "num_experts_per_tok": 2}
    # one prompt of 4 tokens: expert 0 chosen by every token, 1 by two,
    # 2 and 3 by one each; expert 0 kept 3 of its 4 (one choice dropped)
    topi = torch.tensor([[[0, 1], [0, 1], [0, 2], [0, 3]]])
    kept = torch.zeros(1, 4, 4, dtype=torch.bool)
    kept[0, 0, :3] = True
    kept[0, 1, :2] = True
    kept[0, 2, 2] = kept[0, 3, 3] = True
    layer = {"topi": topi, "kept": kept}
    ok = {"topi": topi, "kept": kept.clone()}
    ok["kept"][0, 0, 3] = True
    got = attn_moe.load_spread([[layer, ok]], c)
    assert got["dropped_pct"] == pytest.approx(100 / 8)
    assert got["dropped_mean_pct"] == pytest.approx(100 / 16)
    assert got["load_max"] == pytest.approx(4 / (4 * 2 / 4))


def test_long_and_short_cells_counted_by_hand():
    """phi at one prompt of 32,768 tokens: 32,768 x 32,769 / 2 causal
    pairs a head; minicpm3 at 32 prompts of 256: 256 x 257 / 2 a head and
    prompt, an eighth of the 2k cell's pairs a token."""
    pairs = 32768 * 32769 // 2
    assert workcount.causal_pairs(32768, 32768) == pairs == 536_887_296
    assert workcount.prefill_flops("attn_moe", PHI["config"], 16, 1,
                                   32768) == (
        16 * (2 * 199_294_976 * 32768 + 32 * pairs * 2 * (128 + 128))
        + 2 * 4096 * 32064)
    short = 256 * 257 // 2
    assert workcount.causal_pairs(256, 256) == short == 32_896
    assert workcount.prefill_flops("mla", MINICPM["config"], 62, 32,
                                   256) == (
        62 * (2 * 62_668_800 * 8192 + 32 * 40 * short * 2 * (96 + 64))
        + 2 * 2560 * 73448 * 32)
    assert 4 * (2048 * 2049 // 2) / (32 * short) == pytest.approx(8, rel=0.01)
