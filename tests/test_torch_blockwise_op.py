"""ROADMAP C4: the blockwise attention forward (head dims without a
kernel: hubert's 80, MLA's 288 / 256, kimi-k2's 112) is one operator,
`torch.ops.repro_torch.flash_attention_blockwise_fwd`, for fake tensors,
so the dry-run traces a 32K-token layer as one op instead of the block
loop's ~2,100-4,100 block pairs. On fake tensors at S = 4096 the operator
and the loop give the same output shapes, exactly the same FLOPs
(`FlopCounterMode`) and peak bytes within 10% (`MemTracker`); real
tensors still run the loop and count `blockwise_calls`.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers

# (B, Hq, Hkv, dk, dv, causal, window): hubert-xlarge (16 heads of 80, not
# causal), MLA's absorbed attention (48 heads over one latent kv head,
# 288 / 256, causal; 8 heads here), kimi-k2 (112, GQA 8 / 1 here) with a
# window
FAKE_CASES = [(1, 16, 16, 80, 80, False, 0), (1, 8, 1, 288, 256, True, 0),
              (2, 8, 1, 112, 112, True, 1000)]
S = 4096


class _Ops(TorchDispatchMode):
    """The ops dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _traced(fn, shapes, dtype=torch.bfloat16):
    """fn(q, k, v) on fake tensors: output, FLOPs, peak bytes, ops."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        tracker, flops, ops = MemTracker(), FlopCounterMode(display=False), \
            _Ops()
        with tracker, flops, ops:
            q, k, v = (torch.empty(s, dtype=dtype) for s in shapes)
            out, lse = fn(q, k, v)
        peak = sum(d.get("Total", 0) for d in
                   tracker.get_tracker_snapshot("peak").values())
    return out, lse, flops.get_total_flops(), peak, ops.names


@pytest.mark.parametrize("B,Hq,Hkv,dk,dv,causal,window", FAKE_CASES)
def test_the_operator_traces_as_the_loop(B, Hq, Hkv, dk, dv, causal, window):
    shapes = ((B, Hq, S, dk), (B, Hkv, S, dk), (B, Hkv, S, dv))
    layers.reset_blockwise_calls()
    out, lse, flops, peak, names = _traced(
        lambda q, k, v: layers._flash_forward(q, k, v, causal, window),
        shapes)
    assert layers.blockwise_calls == 1
    w_out, w_lse, w_flops, w_peak, w_names = _traced(
        lambda q, k, v: fa.flash_attention_fwd_plain(
            q, k, v, causal=causal, window=window), shapes)
    assert (out.shape, out.dtype, lse.shape, lse.dtype) \
        == (w_out.shape, w_out.dtype, w_lse.shape, w_lse.dtype) \
        == ((B, Hq, S, dv), torch.bfloat16, (B, Hq, S), torch.float32)
    assert flops == w_flops == fa.blockwise_flops(
        B, Hq, S, S, dk, dv, causal=causal, window=window)
    assert abs(peak - w_peak) <= 0.1 * w_peak, (peak, w_peak)
    assert names.count("repro_torch.flash_attention_blockwise_fwd.default") \
        == 1
    assert len(names) < 20 < len(w_names)


def test_the_dry_runs_recorder_sees_one_custom_op():
    """`launch.hlo.TraceRecorder` counts it among the kernel operators
    (`op_audit["custom"]`) with the loop's FLOPs."""
    from repro_torch.launch.hlo import TraceRecorder, count_ops
    shapes = ((1, 16, S, 80), (1, 16, S, 80), (1, 16, S, 80))
    with FakeTensorMode(allow_non_fake_inputs=True):
        q, k, v = (torch.empty(s, dtype=torch.bfloat16) for s in shapes)
        rec = TraceRecorder(None)
        with rec:
            layers.flash_attention(q, k, v, causal=False)
    assert count_ops(rec.trace, ("custom",)) == {"custom": 1}
    assert sum(r.flops for r in rec.trace.ops) == fa.blockwise_flops(
        1, 16, S, S, 80, 80, causal=False)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (1100, 1100, True, 0), (1100, 1100, True, 300), (700, 1300, False, 0),
    (600, 600, False, 100), (1, 1300, False, 0)])
def test_blockwise_flops_is_what_the_loop_counts(Sq, Skv, causal, window):
    q = torch.zeros((1, 2, Sq, 16))
    k = v = torch.zeros((1, 1, Skv, 16))
    with FlopCounterMode(display=False) as counter:
        fa.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    assert counter.get_total_flops() == fa.blockwise_flops(
        1, 2, Sq, Skv, 16, 16, causal=causal, window=window)


def _qkv(seed, B, Hq, Hkv, S, dk, dv, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dtype) for s in ((B, Hq, S, dk), (B, Hkv, S, dk),
                                      (B, Hkv, S, dv)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_real_cpu_tensors_run_the_loop(dtype):
    """The layer's route on real tensors is the block loop, as before: no
    operator dispatched, `blockwise_calls` counted, the loop's bytes."""
    q, k, v = _qkv(0, 2, 4, 2, 40, 80, 80, dtype)
    layers.reset_blockwise_calls()
    with _Ops() as ops:
        out = layers.flash_attention(q, k, v, causal=True)
    assert layers.blockwise_calls == 1
    assert not any(n.startswith("repro_torch.") for n in ops.names)
    want, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(out, want)


def test_the_operator_on_real_tensors_is_the_loop():
    """The operator's CPU implementation is `flash_attention_fwd_plain`."""
    q, k, v = _qkv(1, 1, 6, 1, 700, 288, 256)
    got = torch.ops.repro_torch.flash_attention_blockwise_fwd(  # repro-lint: allow=RA001
        q, k, v, True, 300)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=300)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
