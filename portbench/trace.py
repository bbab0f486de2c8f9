"""The device's timeline over a stretch of whole batches, from
`torch.profiler`: how long some operation ran on the device (the union of
kernel, copy and set intervals), the stretch's length, the operations
that took most time, and the longest gaps with what the host was doing
when each began.
"""
from __future__ import annotations

import collections

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "portbench.stretch"
TOP = 10                    # device ops and idle gaps kept in a summary


class Stretch:
    """`with Stretch() as s:` profiles the body; `s.summary()` after."""

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """{"busy_s", "window_s", "device_ops": [[name, s]], "idle_gaps":
        [[host op, s]]}; times in seconds as measured."""
        events = self.prof.events()
        window = None
        host, device = [], []
        for e in events:
            r = e.time_range
            if e.device_type == DeviceType.CPU:
                if e.name == MARK:
                    window = (r.start, r.end)
                elif r.end > r.start:
                    host.append((r.start, r.end, e.name))
            elif r.end > r.start and not e.name.startswith("portbench."):
                # (a user range appears on the device too: not work)
                device.append((r.start, r.end, e.name))
        if window is None or not device:
            raise RuntimeError("the profiler saw no device activity")
        w0, w1 = window
        per_op: dict[str, float] = collections.defaultdict(float)
        spans = []
        for s, t, name in device:
            per_op[name[:160]] += (t - s) / 1e6
            s, t = max(s, w0), min(t, w1)
            if t > s:
                spans.append((s, t))
        spans.sort()
        busy, gaps, cur = 0.0, [], None
        edge = w0
        for s, t in spans:
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                if s > edge:
                    gaps.append((edge, s))
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
            edge = max(edge, t)
        if cur is not None:
            busy += cur[1] - cur[0]
        if w1 > edge:
            gaps.append((edge, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
                "device_ops": sorted(per_op.items(),
                                     key=lambda kv: -kv[1])[:TOP],
                "idle_gaps": [[_host_at(host, g0), (g1 - g0) / 1e6]
                              for g0, g1 in gaps[:TOP]]}


def _host_at(host: list, t: float) -> str:
    """The innermost host operation running at time t, and the benchmark
    phase around it."""
    live = [(s, e, n) for s, e, n in host if s <= t < e]
    if not live:
        return "(none)"
    inner = max(live, key=lambda x: x[0])[2]
    phase = [x for x in live if x[2].startswith("portbench.")]
    if not phase or inner.startswith("portbench."):
        return inner
    return f"{max(phase, key=lambda x: x[0])[2]}: {inner}"
