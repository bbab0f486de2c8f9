"""The port's span recorder (`repro_torch.obs`) on the model path, at SMOKE
widths on the CPU: off, it records nothing and changes no output; on, an
`attn_moe` prefill gives one `forward` root with its `attention`, `moe`
(route, dispatch, experts, combine) and `head` spans, the dispatch's
`kept` and `slots` equal an independent count of the routing, an MLA
prefill's attention spans are its per-head calls, the device fields stay
None, the recorder keeps nothing the garbage collector tracks, and
`ranges=True` puts the spans in a `torch.profiler` trace (without ranges
the recorder steps aside there). One test, marked `cuda`, holds the
device times and the bounded event pool on the card.

The file imports nothing of the reference package."""
import dataclasses
import gc
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import forward, init_params, layers

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MLA_ARCH = "minicpm3-4b"
B, S = 2, 32
MOE_PARTS = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def _model(arch: str, device="cpu", **moe_changes):
    cfg = get_config(arch, smoke=True)
    if moe_changes:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def _tokens(cfg, device="cpu"):
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(device)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return torch.equal(a, b)


def test_off_records_nothing_and_on_changes_no_output():
    cfg, model = _model(MOE_ARCH)
    tokens = _tokens(cfg)
    assert obs.span("forward") is obs.span("moe")      # the shared null
    idle = obs.Recorder()                               # never started
    logits_off, cache_off, _ = forward(model, tokens, mode="prefill")
    assert idle.spans() == []
    with obs.recording() as rec:
        logits_on, cache_on, _ = forward(model, tokens, mode="prefill")
    assert rec.spans()
    assert torch.equal(logits_off, logits_on)
    assert _equal(cache_off, cache_on)
    # stopped: nothing more is recorded
    forward(model, tokens, mode="prefill")
    assert len(rec.spans()) == len(idle.spans()) + 2 + 2 * cfg.num_layers \
        + len(MOE_PARTS) * cfg.num_layers
    assert obs.span("moe") is obs.span("forward")


def test_one_recorder_at_a_time():
    with obs.recording():
        with pytest.raises(RuntimeError):
            obs.Recorder().start()
    with obs.recording() as rec:            # the first one stopped
        with obs.span("forward"):
            pass
    assert [s.name for s in rec.spans()] == ["forward"]


def test_the_tree_of_a_moe_prefill():
    cfg, model = _model(MOE_ARCH)
    tokens = _tokens(cfg)
    with obs.recording() as rec:
        for _ in range(2):
            forward(model, tokens, mode="prefill")
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["forward", "forward"]
    by_id = {s.id: s for s in spans}
    for root in roots:
        assert root.attrs == {"mode": "prefill", "B": B, "S": S}
        assert root.root == root.id
        mine = [s for s in spans if s.root == root.id]
        top = _children(mine, root)
        assert [s.name for s in top] == \
            ["attention", "moe"] * cfg.num_layers + ["head"]
        for s in top:                   # SMOKE's head dims: no kernel's
            assert s.attrs == ({"route": "blockwise"}
                               if s.name == "attention" else {})
        for moe in (s for s in top if s.name == "moe"):
            assert [s.name for s in _children(mine, moe)] == MOE_PARTS
        for s in mine:
            assert not _children(mine, s) or s.name in ("forward", "moe")
            if s.parent is not None:
                up = by_id[s.parent]
                assert up.host_start_ns <= s.host_start_ns
                assert s.host_end_ns <= up.host_end_ns
    assert len({r.root for r in roots}) == 2
    # on the CPU the device fields stay empty: never the host clock
    for s in spans:
        assert s.device_start_ms is None and s.device_end_ms is None
        assert s.device_ms is None and s.host_ms > 0
    assert obs.self_ms(roots[0], spans) is None


def _independent_kept(moe: layers.MoE, cfg, x: torch.Tensor) -> int:
    """sum over (row b, expert e) of min(tokens of b choosing e, C), from
    `_moe_route`'s choices."""
    probs = torch.softmax(x.float() @ moe.router.float(), dim=-1)
    chosen, _ = layers._moe_route(probs, cfg.moe.num_experts_per_tok)
    C = layers.moe_capacity(cfg.moe, x.shape[1])
    per_row_expert = (chosen > 0).sum(dim=1)                    # (B, E)
    return int(per_row_expert.clamp(max=C).sum())


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_kept_and_slots_against_the_routing(factor):
    cfg, model = _model(MOE_ARCH, capacity_factor=factor)
    moe = model.blocks[0].moe
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((B, S, cfg.d_model), generator=gen).to(torch.bfloat16)
    with obs.recording() as rec:
        layers.moe_ffn(moe, x, cfg)
    (dispatch,) = [s for s in rec.spans() if s.name == "moe.dispatch"]
    C = layers.moe_capacity(cfg.moe, S)
    E, K = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    assert dispatch.attrs["slots"] == E * B * C
    assert isinstance(dispatch.attrs["kept"], int)
    assert dispatch.attrs["kept"] == _independent_kept(moe, cfg, x)
    if factor < 1:                      # the capacity drops choices
        assert dispatch.attrs["kept"] < B * S * K
    else:
        assert dispatch.attrs["kept"] <= B * S * K


def test_mla_attention_spans_are_its_blockwise_calls():
    """An MLA prefill's attention spans, one a layer, are its per-head
    calls (`mla_per_head_calls`), and none of them is blockwise: each
    reads the kernel's plain route at SMOKE's padded head dim 64."""
    cfg, model = _model(MLA_ARCH)
    tokens = _tokens(cfg)
    before = (layers.blockwise_calls, layers.mla_per_head_calls)
    with obs.recording() as rec:
        forward(model, tokens, mode="prefill")
    attention = [s for s in rec.spans() if s.name == "attention"]
    assert layers.blockwise_calls == before[0]
    assert len(attention) == layers.mla_per_head_calls - before[1] \
        == cfg.num_layers
    for s in attention:                 # the per-head form at (64, 64)
        assert s.attrs == {"route": "plain"}


@pytest.mark.parametrize("d, sq, route", [(64, 32, "plain"),
                                          (64, 1, "decode_plain"),
                                          (96, 32, "blockwise")])
def test_the_attention_span_names_its_route(d, sq, route):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, s, d), generator=gen).to(torch.bfloat16)
               for s in (sq, 32, 32))
    with obs.recording() as rec:
        layers.flash_attention(q, k, v, causal=sq > 1)
    assert [(s.name, s.attrs) for s in rec.spans()] == \
        [("attention", {"route": route})]


def _tracked(rec) -> int:
    """Objects the garbage collector tracks among what the recorder keeps
    (its containers' items, and theirs)."""
    n = 0
    for field in vars(rec).values():
        if isinstance(field, (list, dict)):
            for item in (field.values() if isinstance(field, dict)
                         else field):
                n += gc.is_tracked(item)
                if isinstance(item, (list, dict)):
                    n += sum(map(gc.is_tracked, item.values()
                                 if isinstance(item, dict) else item))
    return n


def test_the_recorder_keeps_nothing_the_collector_tracks():
    cfg, model = _model(MOE_ARCH)
    tokens = _tokens(cfg)
    with obs.recording() as rec:
        forward(model, tokens, mode="prefill")
        gc.collect()
        assert _tracked(rec) == 0
        for _ in range(3):
            forward(model, tokens, mode="prefill")
    gc.collect()
    assert _tracked(rec) == 0
    assert len(rec.spans()) == 4 * (2 + (2 + len(MOE_PARTS))
                                    * cfg.num_layers)


def test_spans_of_threads_nest_apart():
    cfg, model = _model(MOE_ARCH)
    tokens = _tokens(cfg)
    with obs.recording() as rec:
        threads = [threading.Thread(
            target=forward, args=(model, tokens), kwargs={"mode": "prefill"})
            for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["forward"] * 3
    for root in roots:
        assert sum(s.root == root.id for s in spans) == \
            2 + (2 + len(MOE_PARTS)) * cfg.num_layers


def test_a_fake_tensor_trace_records_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, model = _model(MOE_ARCH)
    moe = model.blocks[0].moe
    with obs.recording() as rec:
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16)
            out, _ = layers.moe_ffn(moe, x, cfg)
            assert out.shape == (B, S, cfg.d_model)
    assert rec.spans() == []


def _range_names(prof) -> list:
    """(name, names of its enclosing ranges) of each repro_torch range on
    the host."""
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CPU and \
                e.name.startswith("repro_torch."):
            up, chain = e.cpu_parent, []
            while up is not None:
                chain.append(up.name)
                up = up.cpu_parent
            out.append((e.name, chain))
    return out


@pytest.mark.parametrize("ranges", [True, False])
def test_ranges_in_a_profile(ranges):
    cfg, model = _model(MOE_ARCH)
    tokens = _tokens(cfg)
    with obs.recording(ranges=ranges) as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            forward(model, tokens, mode="prefill")
        forward(model, tokens, mode="prefill")
    found = _range_names(prof)
    roots = [s for s in rec.spans() if s.parent is None]
    if not ranges:                      # steps aside while profiling
        assert found == [] and len(roots) == 1
        return
    assert len(roots) == 2
    names = [n for n, _ in found]
    assert names.count("repro_torch.forward") == 1
    assert names.count("repro_torch.attention") == cfg.num_layers
    assert names.count("repro_torch.moe.dispatch") == cfg.num_layers
    assert names.count("repro_torch.head") == 1
    for name, chain in found:
        if name != "repro_torch.forward":
            assert "repro_torch.forward" in chain, name
        if name.startswith("repro_torch.moe."):
            assert chain[0] == "repro_torch.moe", (name, chain)


@pytest.mark.cuda
def test_device_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device times come from CUDA events")
    cfg, model = _model(MOE_ARCH, device="cuda")
    tokens = _tokens(cfg, "cuda")
    forward(model, tokens, mode="prefill")
    with obs.recording() as rec:
        for _ in range(4):
            forward(model, tokens, mode="prefill")
            torch.cuda.synchronize()
    per_root = 2 + (2 + len(MOE_PARTS)) * cfg.num_layers
    # each root's events go back to the pool once a later root closes
    assert sum(map(len, rec._events.values())) <= 2 * 2 * per_root + 1
    spans = rec.spans()
    assert len(spans) == 4 * per_root and spans[0].name == "forward"
    for s in spans:
        if s.name == "moe.dispatch":
            assert isinstance(s.attrs["kept"], int)
            assert 0 < s.attrs["kept"] <= s.attrs["slots"]
    for s in spans:
        assert s.device_ms is not None and s.device_ms >= 0, s
        kids = _children(spans, s)
        if kids:
            assert sum(k.device_ms for k in kids) <= s.device_ms + 1e-3
            assert obs.self_ms(s, spans) >= -1e-3
        for k in kids:
            assert s.device_start_ms <= k.device_start_ms + 1e-3
            assert k.device_end_ms <= s.device_end_ms + 1e-3
