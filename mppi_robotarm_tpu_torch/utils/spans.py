"""Spans of the port's host paths, on the profiler's clock.

A span is a named stretch of host time inside one of the port's entry
points: its name, start and end in Unix-epoch nanoseconds (the clock
``torch.profiler``'s kineto events are stamped on, so spans lie directly
over a device trace), the span it opened in (its parent) and the
outermost span of its call (its root: one a ``solve`` or ``simulate``
call, the request's identifier), and one count ``n`` where the code that
opens it sets one (the bytes it copied, say).

Spans record while a torch profiler runs, or within :func:`recording`,
the operator's switch.  The outermost span decides once, as it opens,
and every span inside it follows: with neither, a call costs that one
check and allocates nothing, its inner spans being one shared object
that records nothing (false in a test, so a count is computed only where
it is kept).  Recorded spans go into one ring of :data:`CAPACITY`
entries, allocated at the first record; when it wraps the oldest are
dropped, and :func:`between` says whether any dropped one reached into
the interval asked for.

A span is host code around host code.  None opens inside a captured
device program (a CUDA graph's body): its host code runs once, at
capture.  Spans are not ``torch.profiler.record_function`` markers,
which the profiler would lay on the device's timeline as well.  The
recorder serves the one thread the port's calls run on.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

# room for a 20-s traced window of one caller's solves: ~2,000 calls a
# second of ~8 spans each, twice over
CAPACITY = 1 << 19

_profiling = torch._C._autograd._profiler_enabled
_now = time.time_ns


class Span(NamedTuple):
    """A recorded span.  ``index`` counts spans in the order they opened;
    ``parent`` is the index of the span it opened in (-1 for a root),
    ``root`` that of its call's outermost span (its own for a root)."""

    index: int
    name: str
    start: int
    end: int
    parent: int
    root: int
    n: int


class Recorded(NamedTuple):
    """:func:`between`'s answer: the spans that overlap the interval, in
    the order they opened, and how many spans the ring dropped that may
    have (0 when every span reaching into it is kept)."""

    spans: list
    dropped: int


class _Ring:
    """The recorded spans: slot ``index % CAPACITY`` holds span ``index``
    as the fields of :class:`Span`, written as it closes."""

    def __init__(self):
        self.slots = [None] * CAPACITY
        self.opened = 0
        self.lost = 0          # spans overwritten
        self.lost_end = -1     # the latest end among them


_ring = None
_forced = 0
_open: list = []           # indices of the recording spans now open
_deciding = True           # no span open: the next one decides


class _Recording:
    """A span that records: ``start`` and ``end`` its clock reads,
    ``seconds`` once it has closed."""

    __slots__ = ("name", "n", "index", "start", "end")

    def __init__(self, name: str):
        self.name, self.n = name, 0

    def __enter__(self):
        global _ring, _deciding
        r = _ring
        if r is None:
            r = _ring = _Ring()
        self.index = i = r.opened
        r.opened = i + 1
        _open.append(i)
        _deciding = False
        self.start = _now()
        return self

    def __exit__(self, *exc):
        global _deciding
        self.end = end = _now()
        _open.pop()
        i, r = self.index, _ring
        slot = i % CAPACITY
        if i >= CAPACITY:
            old = r.slots[slot]
            if old is not None:
                r.lost += 1
                r.lost_end = max(r.lost_end, old[3])
        r.slots[slot] = (i, self.name, self.start, end,
                         _open[-1] if _open else -1,
                         _open[0] if _open else i, self.n)
        if not _open:
            _deciding = True
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class _Off:
    """The inner span of a call that does not record: one shared object,
    false."""

    __slots__ = ("n",)

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _OffRoot(_Off):
    """The outermost span of a call that does not record: the spans inside
    it follow it until it closes."""

    __slots__ = ()

    def __enter__(self):
        global _deciding
        _deciding = False
        return self

    def __exit__(self, *exc):
        global _deciding
        _deciding = True
        return False


_OFF = _Off()
_OFF_ROOT = _OffRoot()


class _Clock:
    """A span of a call that does not record, which reads the clock all the
    same: ``seconds`` once it has closed.  As the outermost span, the spans
    inside it follow it."""

    __slots__ = ("n", "outermost", "start", "end")

    def __init__(self, outermost: bool):
        self.n, self.outermost = 0, outermost

    def __bool__(self):
        return False

    def __enter__(self):
        global _deciding
        if self.outermost:
            _deciding = False
        self.start = _now()
        return self

    def __exit__(self, *exc):
        global _deciding
        self.end = _now()
        if self.outermost:
            _deciding = True
        return False

    seconds = _Recording.seconds


def span(name: str):
    """A context manager around a stretch of the port's host code, named
    ``name``: a recording span (true; set ``n`` on it to keep a count), or,
    when this call does not record, a shared object that records nothing
    (false)."""
    if _deciding:
        return (_Recording(name) if _forced or _profiling()
                else _OFF_ROOT)
    return _Recording(name) if _open else _OFF


def timed(name: str):
    """:func:`span` that reads its start and end whether it records or
    not, for a caller that keeps the time: ``seconds`` once it has
    closed."""
    if _deciding:
        return _Recording(name) if _forced or _profiling() else _Clock(True)
    return _Recording(name) if _open else _Clock(False)


@contextlib.contextmanager
def recording():
    """Within the block every call records its spans, profiler or not."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def between(lo_ns: int, hi_ns: int) -> Recorded:
    """The recorded spans that overlap [lo_ns, hi_ns], in the order they
    opened, and the spans dropped that may have."""
    r = _ring
    if r is None:
        return Recorded([], 0)
    first = max(0, r.opened - CAPACITY)
    out = []
    for i in range(first, r.opened):
        s = r.slots[i % CAPACITY]
        if s is not None and s[0] == i and s[2] <= hi_ns and s[3] >= lo_ns:
            out.append(Span(*s))
    return Recorded(out, r.lost if r.lost_end >= lo_ns else 0)


def allocated() -> bool:
    """Whether the ring exists, that is whether any span has recorded
    since the process started or :func:`reset`."""
    return _ring is not None


def reset() -> None:
    """Drop every recorded span and the ring."""
    global _ring
    _ring = None
