"""Spans and the launch record of the program's main paths, kept in memory.

``span(name, **attrs)`` brackets a stage of the work. Spans nest through a
per-thread stack; the outermost open span of a thread is a root, and every
span under it carries the root's id, so the spans of one ``generate`` call
(``mage.generate``) or one train step (``mage.train_step``) share an id.
Each finished span goes into a bounded ring (``CAPACITY``, the newest kept)
that ``records()`` reads and ``clear()`` empties.

Always on, at a few clock reads a span: the host start and end, the span's
parent and root, and the hand-written kernels launched while it was the
innermost open span, each with its host time from the launcher's entry to
its return (``count_launch``, called by ``_build.launcher``). The same
launches, on every thread and whether or not a span is open, add up in
process-wide totals by launcher name (``launch_counts``).

On demand, while a ``torch.profiler`` runs or inside ``recording()``, a
span also records a pair of CUDA events on the current stream (its device
milliseconds, resolved by ``records()`` and never waited for while the work
runs) and a ``torch.profiler.record_function(name)`` range. So the
program's spans appear by name in any profiler trace, ``profile_trace``'s
included, beside the operators and kernels they issued. A span opened with
``timed=True``, and every span under it, records its event pair always: the
train step is, so each step's phases carry their device time whether or
not a profiler runs, at a few microseconds of host time a span.
While the current stream is being captured into a CUDA graph a span keeps
host stamps only.

The host stamps are taken on the clock of the profiler's chrome trace: an
event's ``ts`` (microseconds) plus the trace's ``baseTimeNanoseconds`` is
the same wall-clock nanosecond count as ``now_ns()``, so a span read here
lines up with the kernels of an exported trace.

The spans of the main paths:

- ``mage.generate`` (root): ``MagePipeline.generate``; under it
  ``mage.encode`` (the first-frame encode), ``mage.inputs`` (the uploads of
  the caption, speed and prior noise), ``mage.ar_core`` (the AR core,
  cached or naive), one ``mage.slot`` per ``decode_slot`` of the cached
  sampler's eager loop (attribute ``pos``; the anchor is slot 0; a call
  that replays the sampler's CUDA graph opens none, and its replayed
  launches count in ``mage.ar_core``) and ``mage.decode`` (the frame
  decode).
- ``mage.train_step`` (root, timed): one step of ``make_mage_train_step``; under it
  ``mage.cast`` (the compute-dtype copies of the masters), ``mage.forward``
  (the loss terms and the loss, with the frozen ``mage.encode`` inside),
  ``mage.backward`` and ``mage.adam`` (the optimizer's update).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator, Optional

import torch

CAPACITY = 1 << 16

now_ns = time.time_ns  # the profiler's chrome-trace clock (ts + baseTimeNanoseconds)

_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_forced = 0  # open ``recording()`` blocks
_totals: dict = {}  # launches by launcher name, never reset


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class Span:
    """One span: a context manager while open, a record once closed."""

    __slots__ = ("name", "attrs", "timed", "id", "parent", "root", "start_ns", "end_ns",
                 "launched", "launch_ns", "device_ms", "_events", "_range")

    def __init__(self, name: str, attrs: dict, timed: bool = False):
        self.name = name
        self.attrs = attrs
        self.timed = timed
        self.launched: dict = {}
        self.launch_ns = 0
        self.device_ms: Optional[float] = None
        self._events = self._range = None

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.timed = self.timed or (parent is not None and parent.timed)
        stack.append(self)
        traced = _forced or torch.autograd._profiler_enabled()
        if (traced or self.timed) and not _capturing():
            if traced:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            if torch.cuda.is_initialized():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = now_ns()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack().pop()
        _ring.append(self)

    def as_dict(self) -> dict:
        return {"name": self.name, "attrs": self.attrs, "timed": self.timed, "id": self.id,
                "parent": self.parent, "root": self.root, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "host_ms": (self.end_ns - self.start_ns) * 1e-6,
                "launches": dict(self.launched), "launch_ns": self.launch_ns,
                "device_ms": self.device_ms}


def span(name: str, timed: bool = False, **attrs) -> Span:
    """``with span("mage.stage", key=value):`` records the enclosed work;
    ``timed`` records its device time, and that of the spans under it,
    always (not only while traced)."""
    return Span(name, attrs, timed)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record device times and profiler ranges for the spans opened inside,
    as when a profiler runs."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def count_launch(kernel: str, host_ns: int, launches: int = 1) -> None:
    """``launches`` launches of ``kernel`` whose launchers took ``host_ns``
    of host time in all, added to the totals and to this thread's innermost
    open span (none open: the totals only). A CUDA graph's replay adds the
    launches it captured with no host time."""
    _totals[kernel] = _totals.get(kernel, 0) + launches
    stack = _stack()
    if stack:
        top = stack[-1]
        top.launched[kernel] = top.launched.get(kernel, 0) + launches
        top.launch_ns += host_ns


def launch_counts() -> dict:
    """A copy of the launches counted since the process started, by launcher
    name, on every thread (autograd's backward thread too): the launches
    between two reads are their difference."""
    return dict(_totals)


def records() -> list:
    """The finished spans in the ring, oldest first, as dicts: ``name``,
    ``attrs``, ``timed``, ``id``, ``parent`` (None for a root), ``root``, ``start_ns``,
    ``end_ns``, ``host_ms``, ``launches`` (by kernel), ``launch_ns`` and
    ``device_ms`` (None where no events were recorded). Waits for the
    end events not yet resolved."""
    spans = list(_ring)
    for s in spans:
        if s._events is not None:
            s._events[1].synchronize()
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
    return [s.as_dict() for s in spans]


def clear() -> None:
    """Empty the ring (open spans are kept when they close)."""
    _ring.clear()
