"""CUDA graphs of the port's device programs: capture, launch counts, LRU,
and the host boundary of a replayed call.

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

The per-call graphs' boundary with the host takes two more pieces:
:class:`HostInts`, the Python ints of a call (a seed, a step) staged
through one pinned host buffer into the device buffer the program reads,
in one asynchronous copy before the replay; and :class:`Packed`, a
program's result written into one flat buffer a dtype inside the
program, so that a replay's fresh result is one clone a dtype, handed
back as views in the result's own shapes.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops import (cuda_pathgen, cuda_probe, cuda_shard, cuda_sim,
                   cuda_solve, cuda_step)
from . import spans

# every launch count of the port's kernels, as (module, name), then the
# counts of work their wrappers add beside them (the solve kernel's tile
# partials): a replay adds both as its capture recorded them
COUNTERS = ((cuda_solve, "LAUNCHES"), (cuda_step, "HEAD_LAUNCHES"),
            (cuda_step, "TAIL_LAUNCHES"), (cuda_step, "CARRIED_HEADS"),
            (cuda_step, "CLUSTER_TAILS"),
            (cuda_sim, "LAUNCHES"), (cuda_sim, "FLEET_LAUNCHES"),
            (cuda_shard, "SCALE_LAUNCHES"), (cuda_shard, "FINISH_LAUNCHES"),
            (cuda_probe, "SCALE_LAUNCHES"), (cuda_probe, "BIG_LAUNCHES"),
            (cuda_pathgen, "LAUNCHES"), (cuda_solve, "PARTIALS"))
LAUNCH_COUNTS = len(COUNTERS) - 1   # the leading entries that count launches
CAPTURE_STREAMS: dict = {}   # device index -> the stream captures run on
STREAMS: dict = {}           # (stream id, device index) -> its Stream


def launch_counts() -> tuple:
    """The port's kernels' launch counts, in :data:`COUNTERS`' order."""
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def named(counts: tuple) -> str:
    """The non-zero entries of a tuple in :data:`COUNTERS`' order, as
    ``module.NAME value`` for a message."""
    return ", ".join(f"{mod.__name__.rsplit('.', 1)[1]}.{name} {v}"
                     for (mod, name), v in zip(COUNTERS, counts) if v)


def current_stream(device: torch.device):
    """``torch.cuda.current_stream(device)``, one object a stream: on the
    card the current stream's id is read without making one."""
    if device.type != "cuda":
        return torch.cuda.current_stream(device)
    sid, index, kind = torch._C._cuda_getCurrentStream(
        torch.cuda.current_device() if device.index is None
        else device.index)
    own = STREAMS.get((sid, index))
    if own is None:
        own = STREAMS[sid, index] = torch.cuda.Stream(
            stream_id=sid, device_index=index, device_type=kind)
    return own


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


class HostInts:
    """Python ints on their way into a captured program.  ``device`` is
    the int64 buffer the program reads; :meth:`send` fills it from one
    host buffer, pinned on the card, by one asynchronous copy on the
    caller's stream, outside the program, so the program itself reads
    nothing from the host.  The event the copy records keeps the host
    buffer from being rewritten while an earlier call's copy may still
    be queued.  On the CPU (the tests' stand-in) the host buffer is a
    plain tensor and the copy runs at once."""

    def __init__(self, n: int, device: torch.device):
        card = device.type == "cuda"
        self.device = torch.zeros(n, dtype=torch.int64, device=device)
        self.host = torch.zeros(n, dtype=torch.int64, pin_memory=card)
        self.values = self.host.numpy()
        self.sent = torch.cuda.Event() if card else None

    def send(self, values, stream) -> None:
        """Copy ``values`` (n Python ints) into :attr:`device`, in order
        with ``stream``'s later work."""
        if self.sent is not None:
            self.sent.synchronize()
        self.values[:] = values
        self.device.copy_(self.host, non_blocking=True)
        if self.sent is not None:
            self.sent.record(stream)


_TENSOR = object()      # a tensor's place in a result's layout


def _layout(v, leaves: list):
    """The layout of a result: ``_TENSOR`` for a tensor (appended to
    ``leaves``), (type, parts) for a tuple or NamedTuple, else the value
    itself."""
    if isinstance(v, torch.Tensor):
        leaves.append(v)
        return _TENSOR
    if isinstance(v, tuple):
        return type(v), tuple(_layout(x, leaves) for x in v)
    return v


def _build(layout, leaves):
    """The result of ``layout`` with the next of ``leaves`` at each
    tensor's place."""
    if layout is _TENSOR:
        return next(leaves)
    if type(layout) is tuple:
        cls, parts = layout
        items = [_build(p, leaves) for p in parts]
        return cls(*items) if hasattr(cls, "_fields") else cls(items)
    return layout


class Packed:
    """A program's result ``out`` packed into :attr:`flats`, one flat
    buffer a dtype (the tensors' elements in order, made by one ``cat`` a
    dtype inside the captured program; a dtype's one tensor, contiguous
    at the start of its storage, is its own buffer).  :attr:`result` is ``out``'s
    layout over the buffers themselves (views: what the capture returns,
    rewritten by each replay); :meth:`fresh` clones each buffer once and
    returns the result as views of the clones, in the shapes and dtypes
    of ``out``.  A buffer a dtype, not one for all: a caller that keeps
    one field (a flag, say) keeps only its dtype's buffer alive.  A
    tensor with no element is made anew."""

    def __init__(self, out):
        leaves: list = []
        self.layout = _layout(out, leaves)
        self.count = len(leaves)
        by_dtype: dict = {}
        self.views, self.empty = [], []
        for i, t in enumerate(leaves):
            if t.numel():
                by_dtype.setdefault(t.dtype, []).append(i)
            else:
                self.empty.append((i, t.shape, t.dtype, t.device))
        for k, idx in enumerate(by_dtype.values()):
            at = 0
            for i in idx:
                shape = leaves[i].shape
                self.views.append((i, k, shape, torch.empty(
                    shape, device="meta").stride(), at))
                at += leaves[i].numel()
        own = lambda idx: len(idx) == 1 and leaves[idx[0]].is_contiguous() \
            and not leaves[idx[0]].storage_offset()
        self.flats = tuple(
            leaves[idx[0]].view(-1) if own(idx)
            else torch.cat([leaves[i].reshape(-1) for i in idx])
            for idx in by_dtype.values())
        self.result = self._views(self.flats)

    def _views(self, flats) -> Any:
        parts = [None] * self.count
        for i, k, shape, stride, at in self.views:
            parts[i] = flats[k].as_strided(shape, stride, at)
        for i, shape, dtype, device in self.empty:
            parts[i] = torch.empty(shape, dtype=dtype, device=device)
        return _build(self.layout, iter(parts))

    def fresh(self) -> Any:
        """The result, as views of one clone of each buffer, sharing no
        memory with the buffers."""
        return self._views([f.clone() for f in self.flats])
