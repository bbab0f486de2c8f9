"""`moe_grouped_roofline.prefill`: the held experts' least time over the
window's `moe.experts` spans' device time (the port's spans,
`portbench/spans.py`), for the dropless MoE that runs every routed row
(`mla_moe`). The work is each `moe.dispatch` span's `rows` (the held
(token, expert) pairs) through one expert's three matmuls, 3 x 2 x d x f
FLOPs each (f = `moe_intermediate_size`), against reading the span's
`held` experts' weights once and each row in and out once, in bf16
(`workcount.least_seconds`).

It declares the attention probe: `spans.select` keeps the window's spans
only where its `attention` spans number that probe's calls, and no
other metric of the cells it reads in installs the probe."""
from portbench import spans, workcount

PROBES = {"attention": "repro_torch.models.layers:flash_attention"}
spans.start()


def read(r) -> float | None:
    win = spans.window(r)
    if not win:
        return None
    dispatch = [s for s in win
                if s.name == "moe.dispatch" and "rows" in s.attrs]
    experts_s = spans.span_ms(win, "moe.experts") / 1e3
    if not dispatch or experts_s <= 0:
        return None
    c = r.config["config"]
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    least = sum(workcount.least_seconds(
        s.attrs["rows"] * 3 * 2 * d * f,
        2 * (s.attrs["held"] * 3 * d * f + 2 * s.attrs["rows"] * d))
        for s in dispatch)
    return 100.0 * least / experts_s
