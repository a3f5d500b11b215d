"""A per-dock record of spans and counts, and ``torch.profiler`` ranges.

A dock keeps one :class:`DockTimings`: its named spans, each with its
parent and its start and end on the host clock (``time.perf_counter_ns``
from the dock's origin); and its counts, plain integers. On a CUDA device
a span opened with ``device=True`` also holds a pair of CUDA events
recorded on the dock's stream at the same two points; the others are
timed on the host alone, because inside a dock an event costs the host
40-70 µs to create and record (measured on an H100's host). The record's
first event is the origin: the stream is empty when a dock starts (the
previous one ended with a synchronising copy), so host and device times
sit on one origin and the host's lead over the stream can be read for any
device span. Nothing here synchronises: device milliseconds are read from
the events only when asked, after the dock.

Code opens spans with :class:`span` and adds counts with :func:`count`;
both go to the record open on the calling thread (a no-op without one).
While a ``torch.profiler`` session runs, every span also opens a profiler
range of its name. Ranges that exist only for the profiler (the models'
layers and blocks) are opened by :func:`profiler_range` or, on the hot
paths, behind a :func:`profiler_on` check, which is all they cost without
a profiler.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd.profiler import record_function

# whether a torch.profiler session runs on this thread: one C call
profiler_on = torch._C._autograd._profiler_enabled
_NO_RANGE = contextlib.nullcontext()
_get_ident = threading.get_ident
_records: Dict[int, "DockTimings"] = {}  # thread id -> its open record


def profiler_range(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs on
    this thread; a no-op context otherwise."""
    return record_function(name) if profiler_on() else _NO_RANGE


@dataclasses.dataclass(slots=True)
class Span:
    """One span of a :class:`DockTimings`."""

    name: str
    parent: int  # index of the enclosing span in DockTimings.spans, -1 at the top
    start_ns: int  # host clock, from the dock's origin
    end_ns: int = -1  # -1 while open
    start_event: Optional[torch.cuda.Event] = None  # on the dock's stream (CUDA only)
    end_event: Optional[torch.cuda.Event] = None


class DockTimings:
    """One dock's record (``DockingResult.timings``).

    ``dock_id``: unique per pipeline, increasing from 0. ``spans``: every
    :class:`Span` in the order opened (a parent before its children).
    ``counts``: name -> int. ``origin``: the CUDA event recorded when the
    record opened (None off CUDA). Device readings are gone from a record
    that was pickled."""

    def __init__(self, dock_id: int, device=None):
        self.dock_id = dock_id
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._stack: List[int] = []
        self._stream = None
        self.origin: Optional[torch.cuda.Event] = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self.origin = self._event()
        self._t0 = time.perf_counter_ns()

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _open(self, name: str, device: bool) -> int:
        i = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        start = time.perf_counter_ns() - self._t0
        self.spans.append(Span(name, parent, start, -1,
                               self._event() if device and self._stream is not None else None))
        self._stack.append(i)
        return i

    def _close(self, i: int) -> None:
        self._stack.pop()
        s = self.spans[i]
        s.end_ns = time.perf_counter_ns() - self._t0
        if s.start_event is not None:
            s.end_event = self._event()

    def add(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    # readings ---------------------------------------------------------
    def find(self, name: str) -> List[int]:
        """Indices of the spans named ``name``."""
        return [i for i, s in enumerate(self.spans) if s.name == name]

    def host_ms(self, i: int) -> float:
        s = self.spans[i]
        return (s.end_ns - s.start_ns) / 1e6

    def device_ms(self, i: int) -> Optional[float]:
        """Span ``i`` on the device's stream (ms), None without events
        (off CUDA, or a span not opened with ``device=True``)."""
        s = self.spans[i]
        if s.start_event is None or s.end_event is None:
            return None
        s.end_event.synchronize()
        return s.start_event.elapsed_time(s.end_event)

    def lead_ms(self, i: int) -> Optional[float]:
        """How far the host ran ahead of the stream when it opened span
        ``i`` (ms): the stream's start of the span less the host's, both
        from the origin. None without events."""
        s = self.spans[i]
        if self.origin is None or s.start_event is None:
            return None
        s.start_event.synchronize()
        return self.origin.elapsed_time(s.start_event) - s.start_ns / 1e6

    def host_seconds(self, name: str) -> float:
        """Host seconds of the spans named ``name`` that no span of that
        name encloses."""
        total = 0
        for s in self.spans:
            p = s.parent
            while p >= 0 and self.spans[p].name != name:
                p = self.spans[p].parent
            if s.name == name and p < 0:
                total += s.end_ns - s.start_ns
        return total / 1e9

    def __getstate__(self):
        state = dict(self.__dict__, _stream=None, origin=None)
        state["spans"] = [dataclasses.replace(s, start_event=None, end_event=None) for s in self.spans]
        return state


class span:
    """``with span(name):`` a span of the thread's open record (nothing
    without one) and, while a profiler runs, a profiler range of the same
    name. ``device=True``: the span is also timed on the device's stream
    (see the module docstring)."""

    __slots__ = ("name", "device", "_rec", "_i", "_range")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device

    def __enter__(self):
        rec = self._rec = _records.get(_get_ident())
        if rec is not None:
            self._i = rec._open(self.name, self.device)
        self._range = None
        if profiler_on():
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._rec is not None:
            self._rec._close(self._i)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to count ``name`` of the thread's open record, if any."""
    rec = _records.get(_get_ident())
    if rec is not None:
        rec.add(name, n)


class Recorder:
    """Hands out one owner's records, ids increasing from 0."""

    def __init__(self):
        self._ids = itertools.count()

    @contextlib.contextmanager
    def record(self, device=None) -> Iterator[DockTimings]:
        """The thread's open record or, when none is open, a new one (its
        origin recorded now) open on this thread until the block ends."""
        me = _get_ident()
        rec = _records.get(me)
        if rec is not None:
            yield rec
            return
        rec = _records[me] = DockTimings(next(self._ids), device)
        try:
            yield rec
        finally:
            del _records[me]
