"""The port's spans: named, nested intervals of host time at its layer
boundaries, kept in memory for whoever reads them.

``with span("engine.task", batch=7):`` records, when the block exits, one
:class:`Span`: its name, a process-wide id, the id of the span open around
it on the same thread (``parent``, None at the top), its start and end on
``time.perf_counter()``'s clock, the thread and its attributes (a dict the
block may still fill in through the ``attrs`` of the object ``with``
gives). :func:`record` adds a span whose start was taken earlier, possibly
on another thread, with the parent the caller names.

Recording is always on and costs a few hundred nanoseconds a span; the
buffer keeps the newest :data:`CAPACITY` spans and drops the oldest.
:func:`spans` returns them, :func:`clear` empties the buffer.

While a profiler (``torch.profiler`` or the autograd profiler, as
``train --profile`` starts it) records the thread that opens a span, the
span also opens ``record_function("msmc." + name)`` inside it, so that it
lies on the profiler's timeline beside the device's kernels, offset from
``t0`` by a constant (the two clocks differ by one, and the annotation
starts a few microseconds into the span). Without a profiler no
``record_function`` is made.

The spans, their parents and what reads them are listed in PERF.md.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch

__all__ = ["CAPACITY", "PREFIX", "Span", "clear", "record", "span", "spans"]

CAPACITY = 1 << 16  # spans kept; about 20 k a minute under a serving daemon's full load
PREFIX = "msmc."  # of the profiler's annotations


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    t0: float
    t1: float
    thread: int
    attrs: dict


_buffer: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)  # next() on it is atomic under the interpreter lock
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled  # a profiler records this thread
_thread = threading.get_ident
_clock = time.perf_counter


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A span around a ``with`` block (see the module docstring); after the
    block ``t0``, ``t1`` and ``id`` hold what was recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "t0", "t1", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._rf = None
        self.t0 = _clock()
        if _profiling():  # the annotation's calls may give up the interpreter lock: inside the span
            self._rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.t1 = _clock()
        _stack().pop()
        _buffer.append((self.name, self.id, self.parent, self.t0, self.t1, _thread(), self.attrs))


def record(name: str, t0: float, t1: float, parent: Optional[int] = None, **attrs) -> int:
    """Record a span from ``t0`` to ``t1`` (``time.perf_counter()``) under
    the span ``parent``; returns its id, for children to name as theirs."""
    sid = next(_ids)
    _buffer.append((name, sid, parent, t0, t1, _thread(), attrs))
    return sid


def spans() -> List[Span]:
    """The recorded spans, oldest first (in the order they ended)."""
    return [Span._make(s) for s in list(_buffer)]


def clear() -> None:
    _buffer.clear()
