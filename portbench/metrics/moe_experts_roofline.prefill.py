"""`moe_experts_roofline.prefill`: the least time of the experts' work
over the window's `moe.experts` spans' device time (the port's spans,
`portbench/spans.py`). The work is what the kept tokens need, not the
slots the port fills up to its capacity: each `moe.dispatch` span's
`kept` tokens through one expert's three matmuls, 3 x 2 x d x f FLOPs
each, against reading every expert's weights once and each kept token's
row in and out once, in bf16 (`workcount.least_seconds`)."""
from portbench import spans, workcount

PROBES: dict = {}
spans.start()


def read(r) -> float | None:
    win = spans.window(r)
    if not win:
        return None
    dispatch = [s for s in win if s.name == "moe.dispatch"]
    experts_s = spans.span_ms(win, "moe.experts") / 1e3
    if not dispatch or experts_s <= 0:
        return None
    c = r.config["config"]
    d, f, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    least = sum(workcount.least_seconds(
        s.attrs["kept"] * 3 * 2 * d * f,
        2 * (E * 3 * d * f + 2 * s.attrs["kept"] * d)) for s in dispatch)
    return 100.0 * least / experts_s
