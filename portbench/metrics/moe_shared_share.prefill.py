"""`moe_shared_share.prefill`: the device time of the port's `moe.shared`
spans (the shared expert, a SwiGLU over every token), as a share of the
`forward` spans', over the window (`portbench/spans.py`).

It declares the attention probe: `spans.select` keeps the window's spans
only where its `attention` spans number that probe's calls, and no
other metric of the cells it reads in installs the probe."""
from portbench import spans

PROBES = {"attention": "repro_torch.models.layers:flash_attention"}
spans.start()


def read(r) -> float | None:
    win = spans.window(r)
    if not win:
        return None
    shared = spans.span_ms(win, "moe.shared")
    if not shared:
        return None
    return 100.0 * shared / spans.span_ms(win, "forward")
