"""`attention_roofline.prefill`: each `flash_attention` call's least time,
summed, over the calls' event time. A call's least time is the larger of
its operations over 989 TFLOP/s and its bytes over 3.35 TB/s
(`portbench.workcount`): what the inputs need, whatever implements it.
From the call only the batch, the sequence lengths and causality are
taken; the heads and head dims are the configuration's published ones
(`blocks/<kind>.attention_dims`): causal pairs at the real heads, q, k
and v read once and the output written once, in bf16."""
from portbench import workcount
from portbench.inputs import block_module

PROBES = {"attention": "repro_torch.models.layers:flash_attention"}


def read(r) -> float | None:
    calls = r.calls.get("attention") or []
    if not calls:
        return None
    c = r.config
    heads, kv_heads, dk, dv = block_module(c["block_kind"]).attention_dims(
        c["config"])
    least = 0.0
    for _, shapes, opts in calls:
        (b, _, sq, _), (_, _, skv, _) = shapes[:2]
        causal = opts.get("causal", True)
        least += workcount.least_seconds(
            workcount.attention_flops(b, heads, sq, skv, dk, dv, causal),
            workcount.attention_bytes(b, heads, kv_heads, sq, skv, dk, dv))
    return 100.0 * least / (sum(ms for ms, _, _ in calls) / 1e3)
