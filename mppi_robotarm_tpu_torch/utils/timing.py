"""Timing and profiling helpers.

Warm up, fence every timed call on the device, keep the best of N wall
clocks (:func:`simple_timeit`); capture a ``torch.profiler`` trace around a
block, with the port's spans beside the kernels (:func:`trace`).  The
counterparts of ``mppi_robotarm_tpu/utils/timing.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import spans

SPANS_TID = 1       # the trace's row of the port's spans, in its process


@dataclass
class TimingResult:
    name: str
    mean_s: float
    best_s: float
    reps: int

    @property
    def per_second(self) -> float:
        return 1.0 / self.best_s

    def __str__(self) -> str:
        return (f"{self.name}: best {self.best_s*1e3:.3f} ms, "
                f"mean {self.mean_s*1e3:.3f} ms over {self.reps} reps")


def _cuda_devices(out, found=None) -> set:
    """The CUDA devices of every tensor in a (nested) output."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    return found


def _fence(out):
    """Wait for the devices that hold ``out``'s CUDA tensors."""
    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)
    return out


def simple_timeit(fn: Callable, *args, warmup: int = 2, reps: int = 5,
                  name: str = "fn") -> TimingResult:
    """Time ``fn(*args)``: ``warmup`` untimed calls, then ``reps`` timed
    ones, each fenced with ``torch.cuda.synchronize`` when its output holds
    CUDA tensors, so queued device work stays inside the timed region."""
    for _ in range(warmup):
        _fence(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _fence(fn(*args))
        times.append(time.perf_counter() - t0)
    return TimingResult(name=name, mean_s=sum(times) / len(times),
                        best_s=min(times), reps=reps)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    GPU when there is one) and export it into ``log_dir`` as a Chrome
    trace, ``trace.json``, with the port's spans the block recorded
    (``utils/spans.py``) as complete events on a row of their own.  No-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        lo = time.time_ns()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        hi = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans.between(lo, hi).spans)


def _add_spans(path: str, recorded: list) -> None:
    """Write ``recorded`` spans into the Chrome trace at ``path`` as
    complete events (``ph`` "X", category ``port_span``; ``n``, parent and
    root in ``args``), on the file's time base: microseconds after its
    ``baseTimeNanoseconds``, as the profiler writes its own events."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPANS_TID, "args": {"name": "port spans"}})
    for s in recorded:
        events.append({"ph": "X", "cat": "port_span", "name": s.name,
                       "pid": pid, "tid": SPANS_TID,
                       "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"index": s.index, "parent": s.parent,
                                "root": s.root, "n": s.n}})
    with open(path, "w") as f:
        json.dump(doc, f)
