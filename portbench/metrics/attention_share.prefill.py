"""`attention_share.prefill`: the device time between CUDA events around
every call of `repro_torch.models.layers.flash_attention` (the blockwise
loop or the Hopper kernel, whichever the head dims take), as a share of
the time between events around each prefill."""
PROBES = {"attention": "repro_torch.models.layers:flash_attention"}


def read(r) -> float | None:
    calls = r.calls.get("attention") or []
    if not calls or not r.prefill_ms:
        return None
    return 100.0 * sum(ms for ms, _, _ in calls) / sum(r.prefill_ms)
