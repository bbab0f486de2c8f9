"""`moe_slot_use.prefill`: the share of the experts' slots that hold a
token, over the window's `moe.dispatch` spans of the port
(`portbench/spans.py`): the tokens kept (`kept`) over the slots the
expert matmuls run over (`slots`, experts x prompts x capacity). A slot
left empty is computed all the same; a token past its expert's capacity
is dropped for it."""
from portbench import spans

PROBES: dict = {}
spans.start()


def read(r) -> float | None:
    win = spans.window(r)
    if not win:
        return None
    dispatch = [s for s in win if s.name == "moe.dispatch"]
    slots = sum(s.attrs["slots"] for s in dispatch)
    if not slots:
        return None
    return 100.0 * sum(s.attrs["kept"] for s in dispatch) / slots
