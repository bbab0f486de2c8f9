"""`device_idle.prefill`: the share of a profiled stretch of whole batches
in which no kernel, copy or set ran on the device (`torch.profiler`,
`portbench.trace`)."""
PROBES: dict = {}


def read(r) -> float | None:
    p = r.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
