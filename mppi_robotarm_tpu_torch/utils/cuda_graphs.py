"""CUDA graphs of the port's device programs: capture, launch counts, LRU.

The port's counterpart of ``jax.jit``'s compile cache.  Two users share
what is here:

* the per-step loops (``sim/loop.py``) capture a chunk of steps of a
  closed loop, after one uncaptured warm-up step on scratch state;
* the per-call entry points (``mppi/solver.py``: ``solve``,
  ``solve_batched`` and ``viz_rollouts``) capture one call, at a key's
  second call, the first having run uncaptured as the warm-up.

Each keeps its own cache (an ``OrderedDict`` bounded by :func:`lru`), its
own keys and its own rules for the launches a capture may record; what
they share is :func:`capture`: the side stream a capture runs on (one a
device, :func:`capture_stream`), the optional warm-up on it, the capture
itself, and the launches of the port's kernels the capture recorded
(:data:`COUNTERS`), which leave every count as it was, since a captured
launch executes nothing.  :func:`replay` replays a graph on the current
stream and adds the launches it recorded to the counts, so a count reads
the same whether its kernel ran captured or not.  Both are spans of the
calls they serve (``utils/spans.py``): ``graph.capture`` and
``graph.replay``.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops import (cuda_pathgen, cuda_probe, cuda_shard, cuda_sim,
                   cuda_solve, cuda_step)
from . import spans

# every launch count of the port's kernels, as (module, name)
COUNTERS = ((cuda_solve, "LAUNCHES"), (cuda_step, "HEAD_LAUNCHES"),
            (cuda_step, "TAIL_LAUNCHES"), (cuda_step, "CARRIED_HEADS"),
            (cuda_sim, "LAUNCHES"), (cuda_sim, "FLEET_LAUNCHES"),
            (cuda_shard, "SCALE_LAUNCHES"), (cuda_shard, "FINISH_LAUNCHES"),
            (cuda_probe, "SCALE_LAUNCHES"), (cuda_probe, "BIG_LAUNCHES"),
            (cuda_pathgen, "LAUNCHES"))
CAPTURE_STREAMS: dict = {}   # device index -> the stream captures run on


def launch_counts() -> tuple:
    """The port's kernels' launch counts, in :data:`COUNTERS`' order."""
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def named(counts: tuple) -> str:
    """The non-zero entries of a tuple in :data:`COUNTERS`' order, as
    ``module.NAME value`` for a message."""
    return ", ".join(f"{mod.__name__.rsplit('.', 1)[1]}.{name} {v}"
                     for (mod, name), v in zip(COUNTERS, counts) if v)


def capture_stream(device: torch.device):
    """The side stream captures on ``device`` run on, made at its first
    use."""
    own = CAPTURE_STREAMS.get(device.index)
    if own is None:
        own = CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return own


class Captured(NamedTuple):
    """A capture: its graph, what the program returned while it was
    captured (the tensors each replay writes again), the launches of the
    port's kernels it recorded (in :data:`COUNTERS`' order) and the
    seconds its warm-up, capture and instantiation took (its
    ``graph.capture`` span's)."""

    graph: "torch.cuda.CUDAGraph"
    out: Any
    recorded: tuple
    capture_s: float


def capture(program: Callable[[], Any], device: torch.device, stream,
            warmup: Optional[Callable[[], Any]] = None,
            arrivals: bool = False) -> Captured:
    """Capture ``program()`` on :func:`capture_stream` for replay on the
    caller's ``stream``.  ``warmup``, when given, runs first, uncaptured on
    the side stream (it loads what a capture may not).  With ``arrivals``
    the solve kernel's launches on the side stream take ``stream``'s
    arrival counters (``cuda_solve.counters_of``), so a replay shares them
    only with work that runs in order with it; that stream's counters
    must exist already (an uncaptured solve on it made them).  Every
    launch count is left as it was found: the warm-up's launches ran off
    the caller's program and the capture's execute nothing."""
    counts = launch_counts()
    own = capture_stream(device)
    own.wait_stream(stream)
    with spans.timed("graph.capture") as span, (
            cuda_solve.counters_of(device, stream.cuda_stream,
                                   own.cuda_stream)
            if arrivals else contextlib.nullcontext()):
        if warmup is not None:
            with torch.cuda.stream(own):
                warmup()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, stream=own):
                out = program()
        finally:
            recorded = tuple(a - b for a, b in zip(launch_counts(), before))
            for (mod, name), v in zip(COUNTERS, counts):
                setattr(mod, name, v)
    return Captured(graph, out, recorded, span.seconds)


def replay(graph, recorded: tuple) -> None:
    """Replay ``graph`` on the current stream and add the launches its
    capture recorded to the counts."""
    with spans.span("graph.replay"):
        graph.replay()
        for (mod, name), v in zip(COUNTERS, recorded):
            if v:
                setattr(mod, name, getattr(mod, name) + v)


def lru(cache: OrderedDict, key, make: Callable[[], Any], size: int):
    """``cache[key]``, made by ``make()`` when missing, as the most
    recently used entry; the least recently used go beyond ``size``."""
    value = cache.pop(key, None)
    if value is None:
        value = make()
    cache[key] = value
    while len(cache) > size:
        cache.popitem(last=False)
    return value
