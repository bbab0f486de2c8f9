"""`moe_dispatch_share.prefill`: the MoE's device time outside its expert
matmuls, as a share of the prefills': over the window's `moe` spans of
the port (`portbench/spans.py`), each one's device time less its
`moe.experts` child's (what is left: routing, dispatch, combine and the
load-balance loss), over the window's `forward` spans' device time."""
from portbench import spans

PROBES: dict = {}
spans.start()


def read(r) -> float | None:
    win = spans.window(r)
    if not win:
        return None
    moe = [s for s in win if s.name == "moe"]
    experts = [s for s in win if s.name == "moe.experts"]
    if not moe or len(experts) != len(moe):
        return None
    return 100.0 * (spans.span_ms(moe, "moe") - spans.span_ms(
        experts, "moe.experts")) / spans.span_ms(win, "forward")
