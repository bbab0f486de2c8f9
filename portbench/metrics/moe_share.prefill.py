"""`moe_share.prefill`: the device time between CUDA events around every
call of `repro_torch.models.layers.moe_ffn` (routing, dispatch, the
experts and the combine), as a share of the time between events around
each prefill."""
PROBES = {"moe": "repro_torch.models.layers:moe_ffn"}


def read(r) -> float | None:
    calls = r.calls.get("moe") or []
    if not calls or not r.prefill_ms:
        return None
    return 100.0 * sum(ms for ms, _, _ in calls) / sum(r.prefill_ms)
