"""Spans of the port's model path: where a forward's time goes, on the host
and on the device.

A span is a named interval around one piece of work, opened with
`span(name, **attrs)` as a context manager. Recording is off by default:
`span` then returns one shared null context after a single check of a
module global, and makes no event, no object and no profiler range.
`recording()` turns it on for its body and yields the `Recorder`, whose
`spans()` waits for the device once and returns every closed span:

- its name and attrs (`current()` is the innermost open span of the
  thread, whose `set(**attrs)` adds to them; a tensor attr is a count
  left on the device, so that the forward never waits for it, and is read
  then, as a number);
- its id, its parent's id and its root's id: the spans of one `forward`
  call share their root's id;
- host start and end, from `time.perf_counter_ns()`;
- device start and end (ms since the recorder's first device event on
  that device), from CUDA events recorded at the span's start and end
  on its root's stream (the current stream when the root opened), where
  the work runs on a CUDA device. On the CPU they stay None: a device
  time is never taken from the host clock.

Spans nest per thread (the serving engine runs forwards on threads). A
span's device is the one it is given (`device=`), else its parent's,
else the current CUDA device where CUDA is initialised. Under a
fake-tensor trace (the dry-run) nothing is recorded. With
`recording(ranges=True)` each span also opens the profiler range
`repro_torch.<name>` (`torch.profiler.record_function`), so that in a
`torch.profiler` trace every device kernel and every idle gap lies under
the program span that launched it. A recorder without ranges records
nothing while `torch.profiler` runs: the profile then sees the program
as it runs unrecorded.

The recorder keeps nothing that the garbage collector tracks, since
each such object it kept would bring the next full collection (which
stops the host) closer: a closed span is a tuple of numbers and strings;
its CUDA events come from a pool of the recorder's, and go back to it
when a later root closes after the span's root has run on the device
(its device times are read then); device counts go to a buffer on the
device, read by `spans()`.

The spans of the model path, and what they carry:

| span | where | attrs |
| --- | --- | --- |
| `forward` (root) | `Transformer.forward` | `mode`, `B`, `S` |
| `attention` | `layers.flash_attention` (a mesh's: each shard's call) | `route`: `kernel`, `decode` (the card's), `plain`, `decode_plain` (the CPU's), `blockwise` |
| `moe` | `layers.moe_ffn` | |
| `moe.route` | the fp32 router, softmax (or sigmoid) and top-k; the dropless MoE's held-expert counts | |
| `moe.shared` | a `RoutedMoEConfig`'s shared expert | |
| `moe.dispatch` | top-C tokens per (row, expert), gathered into slots; the dropless MoE's held rows sorted by expert and gathered | `slots` (experts x rows x C), `kept` (slots filled, a device count); dropless: `held` (experts held), `rows` (held (token, expert) pairs), `rows_max` (those of the most loaded held expert) |
| `moe.experts` | the three expert matmuls and SiLU x up (dropless: grouped GEMMs) | |
| `moe.combine` | the weighting and each token's K expert rows added | |
| `head` | `Transformer._forward`: the final norm and unembedding | |

`moe`'s children cover it but for the load-balance loss (and, in the
dropless MoE, the shared expert's add).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch

_recorder: Recorder | None = None       # the recording that is on, if any
_NULL = contextlib.nullcontext()
_local = threading.local()              # .stack: this thread's open spans
_ids = itertools.count(1)
COUNTS = 4096                           # device counts a buffer holds


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span, resolved (see the module's docstring)."""
    name: str
    attrs: dict
    id: int
    parent: int | None
    root: int
    host_start_ns: int
    host_end_ns: int
    device_start_ms: float | None
    device_end_ms: float | None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


def self_ms(span: Span, spans: list[Span]) -> float | None:
    """`span`'s device ms less its children's (those of `spans` whose
    parent it is); None where the span or a child has no device times."""
    total = span.device_ms
    for child in spans:
        if child.parent == span.id:
            if child.device_ms is None or total is None:
                return None
            total -= child.device_ms
    return total


def _faking() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def span(name: str, *, device: torch.device | None = None, **attrs):
    """A context manager around one piece of work (see the module's
    docstring); entered, it gives the open span, or None while nothing
    records."""
    rec = _recorder
    if rec is None:
        return _NULL
    if (not rec.ranges and torch._C._autograd._profiler_enabled()) \
            or _faking():
        return _NULL
    return _Open(rec, name, device, attrs)


def current() -> _Open | None:
    """The innermost span open on this thread, or None while nothing
    records."""
    if _recorder is None:
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _index(device: torch.device) -> int:
    """A CUDA device's index, or -1 for any other device."""
    if device.type != "cuda":
        return -1
    return torch.cuda.current_device() if device.index is None \
        else device.index


class _Open:
    """A span being recorded. It lives only while open: on closing, what
    it holds goes to its recorder as a tuple."""
    __slots__ = ("rec", "name", "attrs", "dev", "stream", "id", "parent",
                 "root", "t0", "e0", "range")

    def __init__(self, rec: Recorder, name: str, device, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.dev, self.range = device, None

    def __enter__(self) -> _Open:
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        if self.dev is not None:
            self.dev = _index(self.dev)
        elif up is not None:
            self.dev = up.dev
        else:
            self.dev = torch.cuda.current_device() \
                if torch.cuda.is_initialized() else -1
        if up is not None and up.dev == self.dev:
            self.stream = up.stream
        else:
            self.stream = torch.cuda.current_stream(self.dev) \
                if self.dev >= 0 else None
        self.e0 = self.rec._record(self.dev, self.stream)
        if self.rec.ranges:
            self.range = torch.profiler.record_function(
                f"repro_torch.{self.name}")
            self.range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        self.rec._close(self, t1, self.rec._record(self.dev, self.stream))
        return False

    def set(self, **attrs) -> None:
        """Adds attrs to the span. A tensor is a count, one integer
        element: on a CUDA device it stays there until `spans()`."""
        for key, value in attrs.items():
            if isinstance(value, torch.Tensor):
                if value.device.type == "cuda":
                    self.rec._count(self.id, key, value)
                    continue
                value = int(value.item())
            self.attrs[key] = value


class Recorder:
    """Keeps the spans opened while it is on (`start` .. `stop`, or the
    body of `recording`), in the order they were entered."""

    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self._lock = threading.Lock()
        self._done: list[tuple] = []        # resolved spans
        self._rows: dict[int, list] = {}    # root id -> its closed spans
        self._ended: list[tuple] = []       # (root id, device, end event)
        self._attrs: dict[int, dict] = {}   # span id -> attrs, if any
        self._events: dict[int, list] = {}  # device -> its pool of events
        self._free: dict[int, list] = {}    # device -> free events in it
        self._origin: dict[int, int] = {}   # device -> its first event
        self._buffers: dict[int, list] = {}  # device -> count buffers
        self._counts: list[tuple] = []      # (span id, key, device, slot)

    def start(self) -> Recorder:
        global _recorder
        if _recorder is not None:
            raise RuntimeError("a span recorder is already on")
        _recorder = self
        return self

    def stop(self) -> None:
        global _recorder
        if _recorder is self:
            _recorder = None

    def _record(self, dev: int, stream) -> int:
        """A pool event of device `dev` recorded on `stream`: its index in
        the pool (-1 off CUDA)."""
        if dev < 0:
            return -1
        with self._lock:
            free = self._free.setdefault(dev, [])
            pool = self._events.setdefault(dev, [])
            if free:
                i = free.pop()
            else:
                i = len(pool)
                pool.append(torch.cuda.Event(enable_timing=True))
            self._origin.setdefault(dev, i)
        pool[i].record(stream)
        return i

    def _count(self, span_id: int, key: str, value: torch.Tensor) -> None:
        dev = _index(value.device)
        with self._lock:
            buffers = self._buffers.setdefault(dev, [])
            slot = len(self._counts)
            self._counts.append((span_id, key, dev, slot))
            if slot // COUNTS == len(buffers):
                buffers.append(torch.zeros(COUNTS, dtype=torch.int64,
                                           device=value.device))
        buffers[slot // COUNTS][slot % COUNTS].copy_(value.reshape(()))

    def _close(self, o: _Open, t1: int, e1: int) -> None:
        row = (o.name, o.id, o.parent, o.root, o.t0, t1, o.dev, o.e0, e1)
        with self._lock:
            if o.attrs:
                self._attrs[o.id] = o.attrs
            self._rows.setdefault(o.root, []).append(row)
            if o.parent is not None:
                return
            # a root: those that have run on the device give back their
            # events
            keep = []
            for ended in self._ended + [(o.id, o.dev, e1)]:
                root, dev, end = ended
                if dev < 0 or self._events[dev][end].query():
                    self._resolve(self._rows.pop(root))
                else:
                    keep.append(ended)
            self._ended = keep

    def _resolve(self, rows: list) -> None:
        """Device times of rows whose events are done; the events go back
        to the pool (under the lock)."""
        for name, sid, parent, root, t0, t1, dev, e0, e1 in rows:
            d0 = d1 = None
            if dev >= 0:
                pool, origin = self._events[dev], self._origin[dev]
                d0 = pool[origin].elapsed_time(pool[e0])
                d1 = pool[origin].elapsed_time(pool[e1])
                self._free[dev].extend(e for e in (e0, e1) if e != origin)
            self._done.append((name, sid, parent, root, t0, t1, d0, d1))

    def spans(self) -> list[Span]:
        """Every closed span, in the order entered, after one synchronise
        of each device the spans ran on."""
        with self._lock:
            for dev in self._events:
                torch.cuda.synchronize(dev)
            for rows in self._rows.values():
                self._resolve(rows)
            self._rows = {}
            self._ended = []
            counts = {dev: torch.cat(bufs).tolist()
                      for dev, bufs in self._buffers.items()}
            found: dict[int, dict] = {}
            for sid, key, dev, slot in self._counts:
                found.setdefault(sid, {})[key] = counts[dev][slot]
            done = sorted(self._done, key=lambda row: row[1])
            return [Span(name, {**self._attrs.get(sid, {}),
                                **found.get(sid, {})},
                         sid, parent, root, t0, t1, d0, d1)
                    for name, sid, parent, root, t0, t1, d0, d1 in done]


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Records every span opened in the body, on any thread: yields the
    `Recorder`. `ranges`: each span also opens a profiler range."""
    rec = Recorder(ranges).start()
    try:
        yield rec
    finally:
        rec.stop()
