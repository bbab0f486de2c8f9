"""Execution backends for the port's coding byte path.

One interface, two implementations:

  * `TorchBackend` — the port's kernels (kernels/ops.py) on one torch
    device: CUDA kernels on `cuda` (the default), their plain PyTorch
    versions on `cpu`. Every call is ONE kernel launch (the
    stripe-batched wrappers), counted in `ops.KERNEL_LAUNCHES`.
  * `NumpyBackend` — the host-side GF oracle (core.gf / plan.apply).
    Byte-identical outputs, zero kernel launches.

The `CodingEngine` (engine.py) hands host numpy uint8 arrays to the
backend and gets host numpy arrays back; `TorchBackend` owns the device
round trip. Both copies go through pinned staging, so they run at the
link's DMA rate, and the pinned memory a thread holds is bounded:

  * a call that waits for its result streams its inputs onto the device,
    and its results back into fresh host arrays, through two pinned
    chunks each way of `staging_chunk` bytes, used in turn;
  * the streamed encode (`encode_many_lazy`) keeps a double buffer of
    whole windows, so the array `force` returns is the pinned buffer
    itself; it grows to the largest window the thread dispatched.

A `TorchBackend` is shared by every shard of a sharded front-end, whose
engines flush at the same time from a worker pool. Each thread keeps its
own staging chunks and encode double buffer (a `threading.local`), so one
shard's pinned buffer is never handed to another; the timing totals and
the recorded device intervals are shared and change only under a lock.
"""
from __future__ import annotations

import abc
import threading
import time

import numpy as np
import torch

from repro_torch.core.codec import DecodePlan, RecoveryPlan
from repro_torch.core.codes import Code
from repro_torch.core.gf import gf_matmul
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


class Backend(abc.ABC):
    """Executes batched coding math on (S, ...) uint8 stripe batches."""

    name: str = "abstract"
    uses_kernels: bool = False

    @abc.abstractmethod
    def encode_many(self, code: Code, data: np.ndarray) -> np.ndarray:
        """(S, k, B) data -> (S, n, B) codewords."""

    def encode_many_lazy(self, code: Code, data: np.ndarray):
        """Dispatch an encode WITHOUT waiting for its result.

        Returns an opaque handle that `force` turns into the (S, n, B)
        host array. The streaming checkpoint writer dispatches window
        w+1 before it forces window w, so device work overlaps the host
        landing path. The default (host backends) is eager."""
        return self.encode_many(code, data)

    def force(self, pending) -> np.ndarray:
        """The host array behind an `encode_many_lazy` handle."""
        return np.asarray(pending)

    @abc.abstractmethod
    def recover_many(self, plan: RecoveryPlan,
                     stacked: dict[int, np.ndarray]) -> np.ndarray:
        """One single-failure plan over S stripes: {src: (S, B)} -> (S, B)."""

    @abc.abstractmethod
    def apply_decode_many(self, plan: DecodePlan,
                          stacked: dict[int, np.ndarray]
                          ) -> dict[int, np.ndarray]:
        """One multi-erasure plan over S stripes:
        {src: (S, B)} -> {erased: (S, B)}."""

    @abc.abstractmethod
    def delta_terms(self, M: np.ndarray, deltas: np.ndarray) -> np.ndarray:
        """GF(2^8) matmul M (m, u) @ deltas (u, B) -> (m, B): the parity
        delta terms of a batch of partial updates."""

    @abc.abstractmethod
    def xor_fold_many(self, stacked: np.ndarray) -> np.ndarray:
        """(S, s, B) uint8 -> (S, B) XOR fold along axis 1 — the gateway
        pre-fold primitive and the final combine of folded partials."""


class _Pending:
    """A dispatched encode: its host landing buffer and the event that
    marks the copy into it complete (None on the CPU)."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


class TorchBackend(Backend):
    """The port's kernels on one torch device, one launch per call.

    `device` defaults to "cuda" and raises when no CUDA device is
    present; the CPU runs only when asked for ("cpu"), through the
    kernels' plain versions.

    `times` accumulates where the calls spent their time, in host
    seconds: `pin_s` allocating pinned buffers, `stage_s` copying into
    and out of them, `land_s` waiting for copies to finish; and in device
    milliseconds from CUDA events, summed by `take_times()`: `h2d_ms` and
    `d2h_ms` the copies, `kernel_ms` from the end of the input copy to the
    end of the compute (the kernel, the device-side stack or concatenate
    around it, and any gap while the host issues them). Safe to call
    from several threads at once (see the module docstring)."""

    name = "torch"
    uses_kernels = True
    #: bytes of one pinned staging chunk: a thread's waiting calls hold
    #: four of them (two each way) however large the call
    staging_chunk = 32 << 20

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # per thread: the staging chunks (`chunks`), the encode double
        # buffer (`ring`), what each of its two slots still holds (`busy`)
        # and the next slot
        self._local = threading.local()
        self._lock = threading.Lock()       # guards `times` and `_events`
        self._events: list[tuple] = []
        self.times: dict[str, float] = dict.fromkeys(
            ("pin_s", "stage_s", "land_s", "h2d_ms", "kernel_ms", "d2h_ms"),
            0.0)

    # -- host <-> device -------------------------------------------------------
    def _host(self, nbytes: int) -> torch.Tensor:
        """A fresh host staging buffer: pinned for a CUDA device (PyTorch's
        caching host allocator reuses it only after its copies finish)."""
        t0 = time.perf_counter()
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self._cuda)
        self._add_time("pin_s", time.perf_counter() - t0)
        return buf

    def _add_time(self, key: str, seconds: float) -> None:
        with self._lock:
            self.times[key] += seconds

    def _thread_ring(self) -> threading.local:
        """This thread's staging chunks and encode double buffer, made on
        first use."""
        local = self._local
        if not hasattr(local, "ring"):
            local.chunks = {}
            local.ring = {}
            local.busy = [None, None]
            local.slot = 0
        return local

    def _chunks(self, kind: str) -> list[torch.Tensor]:
        """This thread's two staging chunks for `kind` ("in" / "out")."""
        chunks = self._thread_ring().chunks
        if kind not in chunks:
            chunks[kind] = [self._host(self.staging_chunk) for _ in range(2)]
        return chunks[kind]

    def _pieces(self, sizes: list[int]):
        """The concatenation of buffers of `sizes` bytes cut into chunks of
        at most `staging_chunk` bytes: per chunk, a list of (buffer, start,
        stop)."""
        chunk, room = [], self.staging_chunk
        for i, size in enumerate(sizes):
            start = 0
            while start < size:
                stop = min(size, start + room)
                chunk.append((i, start, stop))
                room -= stop - start
                start = stop
                if not room:
                    yield chunk
                    chunk, room = [], self.staging_chunk
        if chunk:
            yield chunk

    def _ring_buffer(self, kind: str, slot: int, nbytes: int) -> torch.Tensor:
        ring = self._thread_ring().ring
        buf = ring.get((kind, slot))
        if buf is None or buf.numel() < nbytes:
            buf = ring[(kind, slot)] = self._host(nbytes)
        return buf[:nbytes]

    def _event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _wait(self, event) -> None:
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            self._add_time("land_s", time.perf_counter() - t0)

    def _stage(self, arrays: list[np.ndarray], host: torch.Tensor
               ) -> tuple[list[torch.Tensor], tuple]:
        """Copy host arrays into one staging buffer and onto the device
        with one copy; returns one device tensor per array and the events
        around the copy."""
        total = sum(a.size for a in arrays)
        flat = host[:total]
        t0 = time.perf_counter()
        view = flat.numpy()
        off = 0
        for a in arrays:
            view[off:off + a.size] = np.asarray(a, dtype=np.uint8).reshape(-1)
            off += a.size
        self._add_time("stage_s", time.perf_counter() - t0)
        if self._cuda:
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            e0 = self._event()
            dev.copy_(flat, non_blocking=True)
            events = (e0, self._event())
        else:
            dev, events = flat, (None, None)
        out, off = [], 0
        for a in arrays:
            out.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return out, events

    def _start_fetch(self, tensors: list[torch.Tensor],
                     host: torch.Tensor | None
                     ) -> tuple[list[torch.Tensor], object]:
        """Start copying device tensors into one host buffer (None on the
        CPU); returns the host views and the events around the copies."""
        if not self._cuda:
            return [t.contiguous() for t in tensors], (None, None)
        total = sum(t.numel() for t in tensors)
        flat = host[:total]
        views, off, e0 = [], 0, self._event()
        for t in tensors:
            v = flat[off:off + t.numel()].view(t.shape)
            v.copy_(t, non_blocking=True)
            views.append(v)
            off += t.numel()
        return views, (e0, self._event())

    def _finish(self, views: list[torch.Tensor], event
                ) -> list[np.ndarray]:
        """Wait for a fetch's copies (`event` marks their end) and return
        the host arrays."""
        self._wait(event)
        return [v.numpy() for v in views]

    def _record(self, h2d: list, kernel: tuple, d2h: list) -> None:
        """Keep one call's device events: the input copies' (start, end)
        pairs, (end of input, end of compute), the output copies' pairs."""
        if kernel[1] is None:
            return
        with self._lock:
            self._events.append((h2d, kernel, d2h))
            full = len(self._events) >= 1024
        if full:
            self.take_times()

    def _dispatch(self, arrays: list[np.ndarray], compute,
                  host_in: torch.Tensor, host_out: torch.Tensor | None):
        """Stage `arrays` through whole host buffers, run
        `compute(*device_tensors) -> [tensors]`, and start copying its
        results back. Returns the host views and the event marking the end
        of those copies."""
        dev, (h0, h1) = self._stage(arrays, host_in)
        outs = compute(*dev)
        k1 = self._event()
        views, (d0, d1) = self._start_fetch(outs, host_out)
        self._record([(h0, h1)], (h1, k1), [(d0, d1)])
        return views, d1

    def _run(self, arrays: list[np.ndarray], compute) -> list[np.ndarray]:
        """Stream `arrays` onto the device through this thread's staging
        chunks, run `compute(*device_tensors) -> [tensors]`, and stream
        its results back into fresh host arrays, which it returns."""
        flats = [np.asarray(a, dtype=np.uint8).reshape(-1) for a in arrays]
        dev = torch.empty(sum(f.size for f in flats), dtype=torch.uint8,
                          device=self.device)
        slots, busy, h2d, off = self._chunks("in"), [None, None], [], 0
        for j, chunk in enumerate(self._pieces([f.size for f in flats])):
            self._wait(busy[j % 2])         # its last copy left the slot
            buf, n, t0 = slots[j % 2], 0, time.perf_counter()
            view = buf.numpy()
            for i, a, b in chunk:
                view[n:n + b - a] = flats[i][a:b]
                n += b - a
            self._add_time("stage_s", time.perf_counter() - t0)
            e0 = self._event()
            dev[off:off + n].copy_(buf[:n], non_blocking=True)
            busy[j % 2] = self._event()
            h2d.append((e0, busy[j % 2]))
            off += n
        ins, off = [], 0
        for a, f in zip(arrays, flats):
            ins.append(dev[off:off + f.size].view(a.shape))
            off += f.size
        outs = [t.contiguous() for t in compute(*ins)]
        kernel = (h2d[-1][1] if h2d else self._event(), self._event())

        results = [np.empty(tuple(t.shape), dtype=np.uint8) for t in outs]
        dst = [r.reshape(-1) for r in results]
        src = [t.view(-1) for t in outs]
        slots, d2h, last = self._chunks("out"), [], None

        def land(chunk, buf, event):
            self._wait(event)
            t0, n, view = time.perf_counter(), 0, buf.numpy()
            for i, a, b in chunk:
                dst[i][a:b] = view[n:n + b - a]
                n += b - a
            self._add_time("stage_s", time.perf_counter() - t0)

        for j, chunk in enumerate(self._pieces([r.size for r in results])):
            buf, n, e0 = slots[j % 2], 0, self._event()
            for i, a, b in chunk:
                buf[n:n + b - a].copy_(src[i][a:b], non_blocking=True)
                n += b - a
            d2h.append((e0, self._event()))
            if last is not None:            # drain the other slot
                land(*last)
            last = (chunk, buf, d2h[-1][1])
        if last is not None:
            land(*last)
        self._record(h2d, kernel, d2h)
        return results

    def take_times(self) -> dict[str, float]:
        """Fold the recorded device intervals into `times` (synchronizing
        the device) and return a copy of the totals."""
        with self._lock:
            events, self._events = self._events, []
        if events:
            torch.cuda.synchronize(self.device)
            h2d = sum(a.elapsed_time(b) for copies, _, _ in events
                      for a, b in copies)
            kernel = sum(a.elapsed_time(b) for _, (a, b), _ in events)
            d2h = sum(a.elapsed_time(b) for _, _, copies in events
                      for a, b in copies)
            with self._lock:
                self.times["h2d_ms"] += h2d
                self.times["kernel_ms"] += kernel
                self.times["d2h_ms"] += d2h
        with self._lock:
            return dict(self.times)

    def reset_times(self) -> None:
        self.take_times()
        with self._lock:
            for key in self.times:
                self.times[key] = 0.0

    # -- Backend -----------------------------------------------------------------
    def encode_many(self, code, data):
        return self._run([data], lambda d: [ops.encode_many(code, d)])[0]

    def encode_many_lazy(self, code, data):
        """Dispatch one window's encode through the double buffer: two
        pinned input and two pinned output buffers, used in turn. The
        array `force` returns stays valid until this thread's second-next
        call."""
        local = self._thread_ring()
        slot, local.slot = local.slot, local.slot ^ 1
        busy = local.busy[slot]
        if busy is not None and busy.event is not None:
            busy.event.synchronize()       # its copies left this slot
        S, k, B = data.shape
        host_in = self._ring_buffer("in", slot, S * k * B)
        host_out = self._ring_buffer("out", slot, S * code.n * B) \
            if self._cuda else None
        (view,), done = self._dispatch(
            [data], lambda d: [ops.encode_many(code, d)], host_in, host_out)
        pending = local.busy[slot] = _Pending(view, done)
        return pending

    def force(self, pending):
        return self._finish([pending.host], pending.event)[0]

    def recover_many(self, plan, stacked):
        srcs = list(plan.sources)
        return self._run(
            [stacked[s] for s in srcs],
            lambda *d: [ops.recover_many(plan, dict(zip(srcs, d)))])[0]

    def apply_decode_many(self, plan, stacked):
        srcs = list(plan.sources)
        erased = list(plan.erased)

        def compute(*d):
            rec = ops.apply_decode_many(plan, dict(zip(srcs, d)))
            return [rec[e] for e in erased]
        return dict(zip(erased, self._run([stacked[s] for s in srcs],
                                          compute)))

    def delta_terms(self, M, deltas):
        return self._run([deltas], lambda d: [ops.apply_matrix(M, d)])[0]

    def xor_fold_many(self, stacked):
        return self._run([stacked], lambda d: [ops.xor_fold_many(d)])[0]


class NumpyBackend(Backend):
    """Host GF oracle: byte-identical to the kernels, zero launches."""

    name = "numpy"
    uses_kernels = False

    def encode_many(self, code, data):
        S, k, bs = data.shape
        flat = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(k, -1)
        cw = code.encode(flat)                              # (n, S*bs)
        return cw.reshape(code.n, S, bs).transpose(1, 0, 2)

    def recover_many(self, plan, stacked):
        return plan.apply(stacked)          # broadcasts over (S, B)

    def apply_decode_many(self, plan, stacked):
        return plan.apply(stacked)

    def delta_terms(self, M, deltas):
        return gf_matmul(np.ascontiguousarray(M, dtype=np.uint8),
                         np.ascontiguousarray(deltas, dtype=np.uint8))

    def xor_fold_many(self, stacked):
        out = np.zeros((stacked.shape[0], stacked.shape[2]), dtype=np.uint8)
        for i in range(stacked.shape[1]):
            out ^= stacked[:, i]
        return out


#: Registry behind the string spelling of `backend=`.
BACKENDS: dict[str, type[Backend]] = {
    TorchBackend.name: TorchBackend,
    NumpyBackend.name: NumpyBackend,
}


def resolve_backend(backend: Backend | str | None = None) -> Backend:
    """The one place a backend spec becomes a `Backend`.

    `backend` is a `Backend` instance, a registry name ("torch" /
    "numpy"), or None for the default, `TorchBackend("cuda")` — which
    raises when no CUDA device is present rather than falling back to
    the CPU."""
    if backend is None:
        return TorchBackend("cuda")
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        try:
            return BACKENDS[backend]()
        except KeyError:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{sorted(BACKENDS)}") from None
    raise TypeError(f"backend must be a Backend, str, or None, "
                    f"got {type(backend).__name__}")
