"""`head_share.prefill`: the device time of the port's `head` spans (the
final norm and the unembedding, which the port runs over every position
of the prompt though the first token needs only the last), as a share of
the `forward` spans', over the window (`portbench/spans.py`)."""
from portbench import spans

PROBES: dict = {}
spans.start()


def read(r) -> float | None:
    win = spans.window(r)
    if not win:
        return None
    head = spans.span_ms(win, "head")
    if not head:
        return None
    return 100.0 * head / spans.span_ms(win, "forward")
