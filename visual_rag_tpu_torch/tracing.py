"""Spans of the program's host work at its layer boundaries.

``with span(name, **counts):`` marks one piece of host work: a page batch
through the processor, a search batch's dispatch, a training step's
optimizer update. ``counts`` are integers the span carries (pages).

Recording is on exactly while a ``torch.profiler`` session is active in
the calling thread: whoever profiles the program gets its spans, on the
profiler's clock (``time.time_ns()``, the clock of kineto's events), with
no setting of the program's own. Off, ``span`` checks that one condition
and returns a shared no-op context: no record, no allocation of its own,
no CUDA call.

On, each span is appended to an in-memory buffer when it closes. A span
given a CUDA ``device`` also records a timing event on that device's
current stream at its start and at its end; ``device_ms``, the stream's
time between the two, is resolved only when :func:`spans` is read (None
for every other span). The spans put nothing on the device side of a
profiler trace: no ``record_function``, no NVTX range (the profiler would
count those as device operations). The buffer keeps at most ``MAX_SPANS``
records and counts the rest in ``BUFFER.dropped``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

MAX_SPANS = 1_000_000

_profiler_enabled = torch.autograd._profiler_enabled


class Span:
    """One span: its record once closed."""

    __slots__ = ("name", "start_ns", "end_ns", "counts", "device_ms", "_stream", "_events")

    def __init__(self, name: str, counts: Dict[str, int], device: Optional[torch.device]):
        self.name = name
        self.counts = counts
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self._stream = self._events = None
        if device is not None and device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "Span":
        self.start_ns = time.time_ns()
        if self._events is not None:
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(self._stream)
        self.end_ns = time.time_ns()
        BUFFER.add(self)
        return False

    def resolve(self) -> None:
        """Read ``device_ms`` from the two events (waits for the end one)."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._stream = self._events = None


class _Off:
    """The span while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class SpanBuffer:
    """Closed spans, in the order they closed; at most ``limit`` of them."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.records: List[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, sp: Span) -> None:
        with self._lock:
            if len(self.records) < self.limit:
                self.records.append(sp)
            else:
                self.dropped += 1

    def clear(self) -> None:
        with self._lock:
            self.records = []
            self.dropped = 0


BUFFER = SpanBuffer()


def span(name: str, device: Optional[torch.device] = None, **counts: int):
    """A context manager that records one span while the profiler is on;
    with a CUDA ``device``, its stream time as well."""
    if not _profiler_enabled():
        return _OFF
    return Span(name, counts, device)


def spans() -> List[Span]:
    """The closed spans, with their device times resolved."""
    with BUFFER._lock:
        out = list(BUFFER.records)
    for sp in out:
        sp.resolve()
    return out


def clear() -> None:
    """Empty the buffer and reset its count of dropped spans."""
    BUFFER.clear()
