"""Discrete-event core: a cancellable priority queue plus a handler loop
(the port's copy of `repro.sim.events`: the same order, the same ties).

CR-SIM/PR-SIM style simulators keep an ordered map of timestamp -> event
list; here the queue is a plain binary heap with lazy cancellation (the
standard heapq idiom): cancelling marks the entry dead and pop() skips
corpses. Ties break by insertion sequence, so same-timestamp events fire
in schedule order — deterministic replays for free.

`Simulator` is deliberately tiny: handlers are registered per event kind,
`schedule()` is relative to `now`, and `run()` drains until a horizon,
an event budget, or `stop()`. Everything domain-specific (failure
processes, repair scheduling, data-loss detection) lives in the other
sim modules and composes through handlers.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Callable
from typing import Any


@dataclasses.dataclass
class Event:
    """One scheduled occurrence. `payload` is handler-defined."""
    time: float
    seq: int
    kind: str
    payload: dict[str, Any]
    cancelled: bool = False
    popped: bool = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class EventQueue:
    """Binary-heap event queue with lazy cancellation."""

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = 0
        self._live = 0

    def __len__(self) -> int:
        return self._live

    def push(self, time: float, kind: str, **payload) -> Event:
        if time < 0:
            raise ValueError(f"event time must be >= 0, got {time}")
        ev = Event(float(time), self._seq, kind, payload)
        self._seq += 1
        self._live += 1
        heapq.heappush(self._heap, ev)
        return ev

    def cancel(self, ev: Event) -> None:
        """Mark dead; the heap entry is skipped on pop (O(1) cancel).
        Cancelling an event that already fired (was popped) is a no-op —
        a handler may safely cancel a stale handle."""
        if not ev.cancelled and not ev.popped:
            ev.cancel()
            self._live -= 1

    def pop(self) -> Event | None:
        while self._heap:
            ev = heapq.heappop(self._heap)
            if not ev.cancelled:
                ev.popped = True
                self._live -= 1
                return ev
        return None

    def peek_time(self) -> float | None:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].time if self._heap else None


class Simulator:
    """Event loop: register handlers, schedule, run to a horizon.

    Handlers receive (sim, event) and may schedule/cancel freely. The
    clock only moves at event boundaries; `schedule(delay, ...)` (and
    its absolute-time twin `schedule_at`) is the only way to move work
    into the future, so causality is structural.
    """

    def __init__(self):
        self.queue = EventQueue()
        self.now = 0.0
        self.events_handled = 0
        self._handlers: dict[str, Callable[["Simulator", Event], None]] = {}
        self._stopped = False

    def on(self, kind: str,
           handler: Callable[["Simulator", Event], None]) -> None:
        if kind in self._handlers:
            raise ValueError(f"handler for {kind!r} already registered")
        self._handlers[kind] = handler

    def schedule(self, delay: float, kind: str, **payload) -> Event:
        if delay < 0:
            raise ValueError(f"cannot schedule into the past (delay={delay})")
        return self.queue.push(self.now + delay, kind, **payload)

    def schedule_at(self, time: float, kind: str, **payload) -> Event:
        """Absolute-time scheduling (setup code seeding lifetimes drawn
        on the t=0 axis). Same causality rule as `schedule`: the event
        may not land before `now`."""
        if time < self.now:
            raise ValueError(
                f"cannot schedule into the past (t={time} < now={self.now})")
        return self.queue.push(time, kind, **payload)

    def cancel(self, ev: Event) -> None:
        self.queue.cancel(ev)

    def stop(self) -> None:
        """Halt `run` after the current handler returns."""
        self._stopped = True

    def run(self, until: float | None = None,
            max_events: int | None = None) -> float:
        """Drain events; returns the simulation clock when the run ends.

        Ends at the first of: queue empty, next event past `until` (clock
        advances to `until`), `max_events` handled, or a handler called
        stop(). Unknown event kinds are an error — a misspelled kind
        silently dropping events is the classic simulator bug."""
        self._stopped = False
        handled = 0
        while not self._stopped:
            if max_events is not None and handled >= max_events:
                break
            t = self.queue.peek_time()
            if t is None:
                break
            if until is not None and t > until:
                self.now = until
                break
            ev = self.queue.pop()
            assert ev is not None
            self.now = ev.time
            handler = self._handlers.get(ev.kind)
            if handler is None:
                raise KeyError(f"no handler registered for event {ev.kind!r}")
            handler(self, ev)
            handled += 1
            self.events_handled += 1
        if until is not None and self.queue.peek_time() is None \
                and not self._stopped:
            self.now = max(self.now, until)
        return self.now
