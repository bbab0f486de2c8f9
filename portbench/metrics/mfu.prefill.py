"""`mfu.prefill`: the model FLOPs of every batch of the window over the
window's time, as a share of the H100's bf16 peak (989 TFLOP/s, dense).
Counted by `portbench.workcount.prefill_flops`: two FLOPs per matmul
weight per prompt token (a MoE token's router and its routed experts),
causal attention pairs at the published head dims and real heads, the LM
head at each prompt's last position only."""
from portbench import workcount

PROBES: dict = {}


def read(r) -> float | None:
    c = r.config
    flops = workcount.prefill_flops(c["block_kind"], c["config"], c["layers"],
                                    r.traffic["batch"], r.traffic["prompt_len"])
    return 100.0 * flops * r.batches / r.window_s / workcount.PEAK_BF16_FLOPS
