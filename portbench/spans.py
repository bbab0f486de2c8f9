"""The port's own spans over the window, for the metrics that read them.

The port records spans at its layer boundaries (`repro_torch.obs`:
`forward`, `attention`, `moe` and its route, dispatch, experts and
combine, `head`), each with CUDA events on the card. A traced run loads
the cell's metric readers after the port is built and before the warm-up
(`harness.run`); each reader of spans calls `start()` when it is loaded,
which starts the port's recorder once, where the process is the
benchmark's own run (`portbench/run.py` its entry point) on a CUDA card.
It starts nothing anywhere else: a test that loads every reader leaves
the recorder off. The recorder opens no profiler ranges, which the
profiled stretch would count as device work (`trace.py`), and so records
nothing while the stretch's profiler runs: the stretch's readings are
those of the port unrecorded. Against a port without the recorder
nothing starts and every such reader returns None.

The first `window(r)` stops the recorder and keeps its selection for the
other readers: the `forward` roots in the order recorded, the warm-up's
`warmup_batches` skipped, then the window's `r.batches`, each with every
span under it (the profiled stretch and the check's replay follow the
window). It is None where the spans do not match the run's other records
of the same window: the `attention` spans must number the attention
probe's calls (`r.calls["attention"]`), and the roots' device time must lie
within `ROOT_MATCH` of the prefill events' (`r.prefill_ms`). The first read
also prints the window's attention and MoE shares beside the probes'
(standard error).
"""
from __future__ import annotations

import importlib
import pathlib
import sys

from .spec import HERE

ROOT_MATCH = 0.02       # roots' device time against the prefill events'

_recorder = None        # the port's recorder, while on
_read: list = []        # [the window's spans or None], once read


def _benchmark_run() -> bool:
    main = getattr(sys.modules.get("__main__"), "__file__", None)
    return main is not None and pathlib.Path(main).resolve() == \
        HERE / "run.py"


def start() -> None:
    """Starts the port's span recorder, once, in the benchmark's own run
    on a CUDA card; elsewhere, or without a recorder in the port, does
    nothing."""
    global _recorder
    if _recorder is not None or _read or not _benchmark_run():
        return
    import torch
    if not torch.cuda.is_available():
        return
    from . import program
    program._port()
    try:
        obs = importlib.import_module("repro_torch.obs")
    except ImportError:
        return
    _recorder = obs.Recorder(ranges=False).start()


def _stop() -> list | None:
    global _recorder
    if _recorder is None:
        return None
    rec, _recorder = _recorder, None
    rec.stop()
    return rec.spans()


def select(spans: list | None, r) -> list | None:
    """The spans of the window's roots (see the module's docstring), or
    None, with the reason on standard error."""
    if spans is None:
        return None
    roots = [s for s in spans if s.parent is None and s.name == "forward"]
    skip = r.traffic["warmup_batches"]
    keep = roots[skip:skip + r.batches]
    ids = {s.id for s in keep}
    win = [s for s in spans if s.root in ids]
    attention = [s for s in win if s.name == "attention"]
    calls = r.calls.get("attention") or []
    root_ms, prefill_ms = (sum(s.device_ms or 0.0 for s in keep),
                           sum(r.prefill_ms))
    why = None
    if not keep or len(keep) != r.batches:
        why = f"{len(roots)} roots for {skip} + {r.batches} batches"
    elif any(s.device_ms is None for s in win):
        why = "spans without device times"
    elif len(attention) != len(calls):
        why = (f"{len(attention)} attention spans against {len(calls)} "
               f"probed calls")
    elif abs(root_ms - prefill_ms) > ROOT_MATCH * prefill_ms:
        why = (f"roots {root_ms:.3f} ms against the prefill events' "
               f"{prefill_ms:.3f} ms")
    if why is not None:
        print(f"portbench spans: {why}; the span metrics are left out",
              file=sys.stderr)
        return None
    _report(win, keep, r)
    return win


def _report(win: list, roots: list, r) -> None:
    """The window's attention and MoE device shares from the spans beside
    the probes' (`attention_share.prefill`, `moe_share.prefill`), and the
    `moe` spans' self time as a share of theirs."""
    total = span_ms(roots, "forward")
    line = [f"{len(roots)} roots, {len(win)} spans"]
    for name in ("attention", "moe"):
        calls = r.calls.get(name) or []
        probed = 100.0 * sum(c[0] for c in calls) / sum(r.prefill_ms)
        line.append(f"{name} {100.0 * span_ms(win, name) / total:.3f}% "
                    f"(probes {probed:.3f}%, {len(calls)} calls)")
    moe = span_ms(win, "moe")
    if moe:
        obs = importlib.import_module("repro_torch.obs")
        kids: dict = {}
        for s in win:
            kids.setdefault(s.parent, []).append(s)
        own = sum(obs.self_ms(s, kids.get(s.id, [])) for s in win
                  if s.name == "moe")
        line.append(f"moe self {100.0 * own / moe:.3f}% of moe")
    line.append(f"roots {total:.3f} ms, prefill events "
                f"{sum(r.prefill_ms):.3f} ms")
    print("portbench spans: " + "; ".join(line), file=sys.stderr)


def window(r) -> list | None:
    """The window's spans, selected at the first read (the recorder then
    stops), or None."""
    if not _read:
        _read.append(select(_stop(), r))
    return _read[0]


def span_ms(spans: list, name: str) -> float:
    """The device ms of the spans named `name`."""
    return sum(s.device_ms for s in spans if s.name == name)
