"""The program's spans and counters, kept only while a recording is open.

``span(name, device=False)`` marks one stage of the work at the boundary
where it happens (``with trace.span("moe.dispatch", device=x): ...``);
``count(name, value)`` adds to a named counter.  Neither does anything
until ``record()`` opens a recording: then a span is kept as its id, the
id of the innermost span open around it (its parent; -1 for a root), its
name and its start and end on the host clock (``time.time_ns``).  Where
``device`` is a plain CUDA tensor, the span also records a timing event
on that device's current stream as it opens and as it closes, so its
``device_ms`` is the stream's time between the two points: the work the
stage enqueued and any idle time of the stream in between.  A tensor
subclass (a DTensor, a fake tensor) gives a host span only.  Nothing is
read back while the recording is open: ``Record.close`` synchronises,
then reads every event pair and every counter held on the device.

The operator's use, around any run of the port::

    from repro_torch.utils import trace
    with trace.record() as r:
        Experiment(cfg).run(engine="sweep")
    r.spans        # [Span(id, parent, name, t0_ns, t1_ns, device_ms)]
    r.counters     # {"moe.routes": ..., ...}

One recording is open at a time, in one thread.  The kernels' launch
counters (``kernels/_build.Library``, each kernel module's ``LAUNCHES``)
count always and stay where they are.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One closed span of a recording."""
    id: int
    parent: int                  # the enclosing span's id; -1 for a root
    name: str
    t0_ns: int                   # host clock (time.time_ns) as it opened
    t1_ns: int                   # ... and as it closed
    device_ms: Optional[float]   # stream time between its events; None
                                 # for a host span


class _Off:
    """The span of a run that is not recorded: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_REC: Optional["Record"] = None        # the open recording, if any


def span(name: str, device=False):
    """A context manager that marks the stage ``name``; with ``device`` a
    plain CUDA tensor of the stage, it times the stream too.  Without an
    open recording it is one shared object that does nothing."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Span(rec, name, device)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed on its device and read
    when the recording closes) to the counter ``name``; nothing without an
    open recording."""
    rec = _REC
    if rec is not None:
        rec._add(name, value)


def active() -> bool:
    """Whether a recording is open: the guard for a counter whose value
    would cost device work to compute."""
    return _REC is not None


class _Span:
    __slots__ = ("rec", "name", "events", "id", "parent", "t0")

    def __init__(self, rec: "Record", name: str, device):
        self.rec, self.name, self.events = rec, name, None
        if type(device) is torch.Tensor and device.is_cuda:
            stream = torch.cuda.current_stream(device.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)

    def __enter__(self):
        rec = self.rec
        self.id, rec._next = rec._next, rec._next + 1
        self.parent = rec._stack[-1] if rec._stack else -1
        rec._stack.append(self.id)
        if self.events is not None:
            self.events[0].record(self.events[2])
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        rec = self.rec
        rec._stack.pop()
        rec._done.append((self.id, self.parent, self.name, self.t0, t1,
                          self.events))
        return False


class Record:
    """One recording: ``spans`` (by id) and ``counters`` once closed."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self._closed = False
        self._next = 0
        self._stack: List[int] = []     # ids of the open spans
        self._done: List[tuple] = []    # closed spans, events unread
        self._host: Dict[str, float] = {}
        self._dev: Dict[str, torch.Tensor] = {}

    def _add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            held = self._dev.get(name)
            self._dev[name] = (value.detach().clone() if held is None
                               else held + value.detach())
        else:
            self._host[name] = self._host.get(name, 0) + value

    def close(self) -> None:
        """Synchronise the card (where a span or counter used it), then
        resolve each device span's milliseconds and each counter to a
        number.  A second call does nothing."""
        if self._closed:
            return
        self._closed = True
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        spans = []
        for sid, parent, name, t0, t1, ev in sorted(self._done,
                                                    key=lambda r: r[0]):
            ms = None if ev is None else float(ev[0].elapsed_time(ev[1]))
            spans.append(Span(sid, parent, name, t0, t1, ms))
        self.spans = spans
        counters = dict(self._host)
        for name, t in self._dev.items():
            counters[name] = counters.get(name, 0) + t.item()
        self.counters = counters
        self._done, self._dev = [], {}


@contextlib.contextmanager
def record() -> Iterator[Record]:
    """Record every span and counter of the block; the ``Record`` yielded
    is closed (resolved) as the block ends."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a trace recording is already open")
    rec = Record()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        rec.close()
