"""The plain reference against the port's CPU path at SMOKE widths, both
in float32: the same weights (drawn by the benchmark, loaded into the
port) and prompts give the same last logits and caches."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from portbench_cases import small_spec

from portbench import check, program
from portbench.inputs import Prompts, Weights
from portbench.reference.model import Forward
from portbench.reference.precision import FP32

CPU = torch.device("cpu")


def _both(sp, seed: int = 11):
    """(prompts, (port model, its logits), its cache, reference) on 2 x 64
    tokens, all in fp32."""
    c = sp.config["config"]
    weights = Weights(sp.config, seed, CPU)
    prompts = Prompts(seed, "prompts", c["vocab_size"], 2, 64, CPU).next()
    model, prefill = program.build(sp.config, weights, CPU)
    model.float()
    logits, cache = prefill(model, prompts)
    ref = Forward(sp.config, weights, prompts, FP32)
    return prompts, (model, logits), cache, ref


@pytest.mark.parametrize("kind", ["mla", "attn_moe"])
def test_reference_matches_port_fp32(kind):
    sp = small_spec(kind)
    prompts, (_, logits), cache, ref = _both(sp)
    out = check.ProgramOutputs(
        sp.config, [{"prompts": prompts, "logits": logits,
                     "tokens": logits.argmax(-1), "cache": cache}])
    for li, rc, _, _ in ref:
        pc = out.layer(li)
        for name, r in rc.items():
            err = (pc[name] - r).norm() / r.norm()
            assert err < 1e-5, (kind, li, name, err.item())
    err = (logits.float() - ref.logits).norm() / ref.logits.norm()
    assert err < 1e-5, (kind, err.item())


def test_reference_matches_port_with_ghost_heads(monkeypatch):
    """minicpm3's port pads its heads (40 to 48); here 4 to 8: the ghost
    heads the loader derives change nothing."""
    sp = small_spec("mla")
    base = program.port_config(sp.config)
    monkeypatch.setattr(program, "port_config",
                        lambda config: dataclasses.replace(base,
                                                           tp_pad_heads=8))
    _, (model, logits), _, ref = _both(sp, seed=12)
    for _ in ref:
        pass
    assert model.blocks[0].mla.w_uk.shape[0] == 8
    err = (logits.float() - ref.logits).norm() / ref.logits.norm()
    assert err < 1e-5, err.item()


def test_fp8_reference_departs_from_fp32():
    """The control's format rounds every product operand to e4m3 under a
    per-tensor scale: relative error of a few percent, none in fp32."""
    from portbench.reference.precision import FP8
    x = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))
    e8 = ((FP8.op(x) - x).norm() / x.norm()).item()
    assert 0.01 < e8 < 0.08
    assert torch.equal(FP32.op(x), x)


def _untiled(q, k, v, scale):
    """The whole (H, S, S) formula: scores, a causal mask, softmax, v."""
    g = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(g, dim=0), v.repeat_interleave(g, dim=0)
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    n = s.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool).tril()
    return torch.matmul(torch.softmax(s.masked_fill(~mask, float("-inf")),
                                      dim=-1), v)


@pytest.mark.parametrize("fp8", [False, True])
def test_attention_in_query_tiles_is_the_whole_formula(monkeypatch, fp8):
    """Tiles of 64 query rows over S = 200 (the last tile partial), 8 query
    heads over 2 key heads: the whole formula to fp32 rounding; in fp8 the
    whole formula over q, k and v each rounded whole (one per-tensor
    scale, not a tile's)."""
    from portbench.reference import model
    from portbench.reference.precision import FP8
    monkeypatch.setattr(model, "TILE", 64)
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(8, 200, 24, generator=gen)
    k = torch.randn(2, 200, 24, generator=gen)
    v = torch.randn(2, 200, 16, generator=gen)
    # one query tile's rows an order larger, so that a tile's own fp8 scale
    # would round the others differently
    q[:, 64:128] *= 8.0
    prec = FP8 if fp8 else FP32
    got = model.causal_attention(q, k, v, 24 ** -0.5, prec)
    want = _untiled(prec.op(q), prec.op(k), prec.op(v), 24 ** -0.5)
    assert got.shape == (8, 200, 16)
    err = ((got - want).norm() / want.norm()).item()
    assert err < 1e-6, err
