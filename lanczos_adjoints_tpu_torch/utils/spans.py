"""Spans inside the port: named host ranges, their device time, and the kernel launches made in them.

A span is recorded only while a ``torch.profiler`` is recording. Otherwise
``span(name)`` costs one check and returns a shared object that does
nothing: no ``record_function``, no CUDA event, no allocation. While one
records, a span keeps in memory its name, its parent, its host start and
end on the profiler's clock (Unix nanoseconds: ``trace_start_ns`` plus an
event's offset), a CUDA-event pair on the current stream where a card is
present, and the number of the ``ops.native`` registry's launches made
inside it, by kernel. It also opens ``record_function("lat.<name>")``, so
that it lies on the profiler's timeline beside the device's events; its
host start and end lie inside that range, its own event pair outside
them.

Parents follow a stack per thread. Backward runs on the autograd engine's
device thread: a span that opens with an empty stack while a top-level
span is open on another thread (the one that called ``backward()``)
takes that span as its parent. The rule assumes one calling thread.

``Kernel.launch`` reports each accepted launch to ``launched``: while a
profiler records, it is counted in the innermost open span. A launch
takes no event pair of its own: under the profiler a pair costs 40 us or
more of host time, and the profiler's kernel events give each launch's
device time.

The store is kept after a recording stops, and cleared at the first span,
launch or read that finds a new one. ``records()`` resolves the events
after one synchronise.
"""

import functools
import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _profiler

PREFIX = "lat."


@dataclass(frozen=True)
class Record:
    """A closed span. ``parent`` indexes the list ``records()`` returns;
    ``launches`` is ``{kernel: launches made with this span innermost}``;
    device times are seconds, ``None`` without a card."""

    name: str
    parent: int | None
    start_ns: int
    end_ns: int
    device_s: float | None
    self_device_s: float | None
    launches: dict

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Store:
    def __init__(self):
        self.live = False  # whether a recording was on at the last check
        self.local = threading.local()
        self.streams = {}  # (device, raw stream) -> torch.cuda.Stream
        self.clear(cuda=False)

    def clear(self, *, cuda: bool):
        self.cuda = cuda  # whether spans take event pairs
        self.spans = []  # in opening order
        self.roots = []  # open top-level spans

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def innermost(self):
        stack = self.stack()
        if stack:
            return stack[-1]
        return self.roots[-1] if self.roots else None


_STORE = _Store()


def tracing() -> bool:
    """Whether a profiler records; clears the store when a recording has started."""
    on = _profiler._is_profiler_enabled
    if on != _STORE.live:
        _STORE.live = on
        if on:
            _STORE.clear(cuda=torch.cuda.is_available())
    return on


def _stream():
    """PyTorch's current CUDA stream, built once for each device and raw
    stream: ``torch.cuda.current_stream()`` costs 6-9 us a call on the
    card's host, which ``Event.record()`` would pay at every event."""
    device = torch._C._cuda_getDevice()
    key = (device, torch._C._cuda_getCurrentRawStream(device))
    stream = _STORE.streams.get(key)
    if stream is None:
        stream = _STORE.streams[key] = torch.cuda.current_stream(device)
    return stream


class _Span:
    __slots__ = ("name", "parent", "start_ns", "end_ns", "events", "launches", "_range")

    def __init__(self, name):
        self.name = name
        self.end_ns = None
        self.events = None
        self.launches = {}

    def __enter__(self):
        stack = _STORE.stack()
        self.parent = _STORE.innermost()
        if self.parent is None:
            _STORE.roots.append(self)
        stack.append(self)
        _STORE.spans.append(self)
        self._range = _profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if _STORE.cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(_stream())
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(_stream())
        self._range.__exit__(*exc)
        _STORE.stack().pop()
        if self in _STORE.roots:
            _STORE.roots.remove(self)
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A context manager recording the span ``name`` while a profiler records."""
    return _Span(name) if tracing() else _NULL


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def launched(kernel: str) -> None:
    """Count an accepted launch of ``kernel`` in the innermost open span,
    while a profiler records."""
    if tracing():
        inner = _STORE.innermost()
        if inner is not None:
            inner.launches[kernel] = inner.launches.get(kernel, 0) + 1


def records() -> list:
    """The closed spans of the last recording, in opening order, as ``Record``s."""
    tracing()  # a later recording then starts from an empty store
    if _STORE.cuda:
        torch.cuda.synchronize()
    closed = [s for s in _STORE.spans if s.end_ns is not None]
    index = {id(s): i for i, s in enumerate(closed)}
    device = [None if s.events is None else s.events[0].elapsed_time(s.events[1]) / 1e3 for s in closed]
    inside = [0.0] * len(closed)
    for s, d in zip(closed, device):
        parent = index.get(id(s.parent))
        if parent is not None and d is not None:
            inside[parent] += d
    return [
        Record(s.name, index.get(id(s.parent)), s.start_ns, s.end_ns, d,
               None if d is None else d - inside[i], dict(s.launches))
        for i, (s, d) in enumerate(zip(closed, device))
    ]

