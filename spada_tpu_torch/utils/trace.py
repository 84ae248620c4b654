"""Spans of the port's steps: planning, host layout and upload, launches.

A span records one step: its name, its start and end on
``time.perf_counter_ns()``, its parent (the span open on the same thread
when it began, else None) and a few attributes (counts, sizes, the
kernel's name and block).  Finished spans are kept in memory as plain
tuples, the newest :data:`LIMIT` of them, and read back with :func:`spans`.

Two kinds of span differ in when they are recorded:

- set-up spans (:func:`span`): always.  They happen once per structure or
  value set and last milliseconds to seconds;
- the spans of a kernel launch (:func:`launch`: ``launch`` and its children
  ``launch.check``, ``launch.alloc``, ``launch.call``): only while
  :func:`active`, that is under ``SPADA_TRACE=1``, after :func:`enable`, or
  while a ``torch.profiler`` is recording.  The wrappers test
  :func:`active` once per launch and record nothing otherwise.

While a ``torch.profiler`` records, each top-level span also opens a
profiler range of its name, so that a profiler trace (:func:`profile`)
shows the port's steps above the kernels they enqueue.  The range is the
one ``torch.profiler.record_function`` opens, entered directly
(``_RecordFunctionFast``): ``record_function`` enters and leaves it through
two dispatched operators, which under a profiler of the device added
35-75 us to each launch on an H100's host (PERF.md).  :func:`profiler_ns`
maps a span's time onto that trace's clock.

Nothing is printed per span.  Under ``SPADA_TRACE=1`` the spans are written
once, as one JSON document on standard error, when the process exits;
:func:`dump` writes them to a file on request.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
from typing import Callable, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: the most finished spans kept; the oldest go first
LIMIT = 1 << 18

#: one finished span, as :func:`spans` returns it
Span = collections.namedtuple("Span", "id name start_ns end_ns parent attrs")

_enabled = os.environ.get("SPADA_TRACE", "") not in ("", "0")
_done = collections.deque(maxlen=LIMIT)   # (id, name, start, end, parent, attrs)
_ids = itertools.count(1)
_local = threading.local()


def enable(on: bool = True) -> None:
    """Record launch spans (``on``) or only while a profiler records."""
    global _enabled
    _enabled = on


def active() -> bool:
    """Whether launch spans are recorded now: tracing is enabled or a
    ``torch.profiler`` is recording."""
    return _enabled or _profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """A span that has begun and not ended."""

    __slots__ = ("id", "name", "start", "parent", "attrs", "rf")

    def __init__(self, name: str, attrs: Optional[dict]):
        stack = _stack()
        self.id = next(_ids)
        self.name = name
        self.attrs = attrs
        self.parent = stack[-1].id if stack else None
        self.rf = None
        if self.parent is None and _profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast(name)
            self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()

    def end(self) -> None:
        t = time.perf_counter_ns()
        stack = _stack()
        if self in stack:
            # children a raise left open end with their parent
            while stack.pop() is not self:
                pass
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _done.append((self.id, self.name, self.start, t, self.parent,
                      self.attrs))


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record a set-up span around the block; yields its attribute dict,
    to which the block may add."""
    s = _Open(name, attrs)
    try:
        yield attrs
    finally:
        s.end()


def spanned(name: str, attrs: Optional[Callable[..., dict]] = None):
    """Decorator: record a set-up span ``name`` around each call, with the
    attributes ``attrs`` gives for the call's arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, **(attrs(*args, **kwargs) if attrs else {})):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Launch:
    """The spans of one kernel launch: ``launch`` and the phase open in it."""

    __slots__ = ("outer", "phase")

    def __init__(self, kernel: str, attrs: dict):
        attrs["kernel"] = kernel
        self.outer = _Open("launch", attrs)
        self.phase = _Open("launch.check", None)

    def step(self, phase: str, **attrs) -> None:
        """End the current phase and begin ``phase``; ``attrs`` go on the
        ``launch`` span."""
        self.phase.end()
        self.outer.attrs.update(attrs)
        self.phase = _Open(phase, None)

    def end(self) -> None:
        self.phase.end()
        self.outer.end()


def launch(kernel: str, **attrs) -> _Launch:
    """Begin the spans of one launch of ``kernel`` (``launch``, and in it
    ``launch.check``).  The wrapper calls this only where :func:`active`,
    moves on with :meth:`_Launch.step` to ``launch.alloc`` and
    ``launch.call``, and ends it with :meth:`_Launch.end` in a ``finally``."""
    return _Launch(kernel, attrs)


def spans(name: Optional[str] = None) -> List[Span]:
    """Finished spans (all, or those called ``name``) in the order they
    ended; ``attrs`` is a dict, empty where the span had none."""
    return [Span(i, n, s, e, p, a or {}) for i, n, s, e, p, a in list(_done)
            if name is None or n == name]


def clear() -> None:
    _done.clear()


def _profiler_offset_ns() -> int:
    """What to add to a ``perf_counter_ns`` time to put it on the clock of
    ``torch.profiler``'s events (kineto stamps host and device events with
    the wall clock, ``CLOCK_REALTIME``), read now: the pair of clock reads
    closest together of five."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        w = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, w - (p0 + p1) // 2)
    return best[1]


def profiler_ns(t_ns: int) -> int:
    """A span's ``perf_counter_ns`` time on ``torch.profiler``'s clock."""
    return t_ns + _profiler_offset_ns()


def _document() -> dict:
    return {"clock": "perf_counter_ns",
            "profiler_offset_ns": _profiler_offset_ns(),
            "fields": list(Span._fields),
            "spans": [[i, n, s, e, p, a or {}]
                      for i, n, s, e, p, a in list(_done)]}


def dump(path: str) -> None:
    """Write every finished span to ``path`` as one JSON document."""
    with open(path, "w") as f:
        json.dump(_document(), f)


def _dump_at_exit() -> None:
    if _enabled:
        json.dump(_document(), sys.stderr)
        sys.stderr.write("\n")
        sys.stderr.flush()


if _enabled:
    atexit.register(_dump_at_exit)


@contextlib.contextmanager
def profile(logdir: str):
    """Host and CUDA profiler timeline (``torch.profiler``), written to
    ``logdir`` as a Chrome trace (``chrome://tracing``, Perfetto), with the
    port's top-level spans as ``record_function`` ranges above the
    kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
