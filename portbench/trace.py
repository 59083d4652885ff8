"""Device time from ``torch.profiler``: what ran on the card, when, and
for how long, read from one traced window.

The profiler arithmetic follows ``mppi_robotarm_tpu_torch/tools/
fused_timing.py::profiled_us`` at commit
d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7: CUDA activity only, and a window
that comes back with no device operation at all (seen on that machine) is
traced again.  Unlike it, the window's busy time and its span come from
the same trace: the busy time is the union of the device operations'
intervals, the span runs from the window's first traced event (a runtime
call on the host) to its last (the closing synchronise), so the idle
share 1 - busy / span never mixes two windows.  Times are kept in
nanoseconds of the profiler's clock.
"""

from __future__ import annotations

import re
from typing import Callable, NamedTuple

from . import stats

TRIES = 3


class Trace(NamedTuple):
    """Device operations (short name, start, end), in order of start, and
    the traced window's (start, end)."""

    ops: list
    span: tuple

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return stats.union_length([(a, b) for _, a, b in self.ops]) * 1e-9

    def kernel(self, name: str):
        """(seconds, launches seen) of the device operations called
        ``name``."""
        hits = [b - a for n, a, b in self.ops if n == name]
        return sum(hits) * 1e-9, len(hits)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle gaps by
        the operation the device waited for, each summed by name, in
        seconds, ``top`` of each."""
        busy, idle = {}, {}
        for n, a, b in self.ops:
            busy[n] = busy.get(n, 0) + (b - a) * 1e-9
        for a, b, i in stats.gaps([(a, b) for _, a, b in self.ops],
                                  *self.span):
            key = ("host, then " + self.ops[i][0] if i is not None
                   else "host, to the end of the window")
            idle[key] = idle.get(key, 0) + (b - a) * 1e-9
        order = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(busy), "idle_gaps": order(idle)}


def short_name(name: str) -> str:
    """A kernel's bare name ("void fleet_kernel<4>(SimParams, ...)" →
    "fleet_kernel"); copies and sets keep their kind ("Memcpy DtoD")."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = re.sub(r"<.*", "", name.split("(")[0]).strip()
    return name.split()[-1].split("::")[-1] if name else name


def from_events(events) -> Trace:
    """A Trace of the profiler's kineto events: device events are the
    operations, every event bounds the span."""
    ops, lo, hi = [], None, None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
        if str(e.device_type()).endswith("CUDA"):
            ops.append((short_name(e.name()), start, end))
    ops.sort(key=lambda o: o[1])
    return Trace(ops, (lo or 0, hi or 0))


def traced(fn: Callable):
    """``fn(closed)`` under the profiler (CUDA activity), where the window
    calls ``closed()`` the moment it closes, which ends the trace before
    the window's bookkeeping: (its result, the Trace).  A window with no
    device operation is run again, up to ``TRIES`` windows; the last is
    returned either way."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRIES):
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        try:
            out = fn(prof.stop)
        finally:
            if getattr(prof.profiler, "kineto_results", None) is None:
                prof.stop()
        tr = from_events(prof.profiler.kineto_results.events())
        if tr.ops:
            break
    return out, tr
