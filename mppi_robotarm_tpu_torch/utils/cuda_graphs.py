"""CUDA graphs of the port's device programs: one cache rule for both of
the port's users, launch counts, and the host boundary of a replay.

The port's counterpart of ``jax.jit``'s compile cache.  Two users run
their device programs through :func:`run`, each with its own cache (an
``OrderedDict`` of :data:`CACHE_SIZE` entries, least recently used out):
the per-call entry points (``mppi/solver.py::_call``: ``solve``,
``solve_batched`` and ``viz_rollouts``), one program a call, and the
per-step loops (``sim/loop.py``), one program a chunk of steps, whose
state a replay carries into the next.  One rule set serves both
(:func:`run`): the entry (:class:`Entry`), the warm-up (a key's first use
uncaptured, its second captured), the staging of the inputs by role
(ints through :class:`HostInts`, a path read where it lies, every other
tensor copied unless it already is the entry's buffer), the launch check
by counter name (:func:`expect`) and the switch (:func:`uncaptured`,
:data:`DEVICES`, :func:`captures`).

:func:`capture` runs a capture on a side stream (one a device,
:func:`capture_stream`) and leaves every count (:data:`COUNTERS`) as it
was, since a captured launch executes nothing; :func:`replay` replays a
graph on the current stream and adds the launches it recorded to the
counts, so a count reads the same whether its kernel ran captured or
not.  Spans (``utils/spans.py``): ``graph.key``, ``graph.warm``,
``graph.capture``, ``graph.copy_in`` (``n``: the bytes it staged, ints
included) and ``graph.replay``.  :class:`Packed` is the per-call users'
result written into one flat buffer a dtype inside the program, so that
a replay's fresh result is one clone a dtype, handed back as views in
the result's own shapes.  :class:`Branch` forks work off the current
stream and joins it back: in a captured program, a branch of the graph
(the loop's step statistics beside the next solve, ``sim/loop.py``).
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops import (cuda_pathgen, cuda_probe, cuda_shard, cuda_sim,
                   cuda_solve, cuda_step)
from . import spans

# every launch count of the port's kernels, as (module, name), with the
# launches of K2 and K3 whose window scan took its compiled width
# (``cuda_sim.scan_width``), then the counts of work their wrappers add
# beside them (the solve kernel's tile partials): a replay adds both as
# its capture recorded them
COUNTERS = ((cuda_solve, "LAUNCHES"), (cuda_step, "HEAD_LAUNCHES"),
            (cuda_step, "TAIL_LAUNCHES"), (cuda_step, "STATS_LAUNCHES"),
            (cuda_step, "CARRIED_HEADS"), (cuda_solve, "COMPILED_SCANS"),
            (cuda_step, "CLUSTER_TAILS"),
            (cuda_sim, "LAUNCHES"), (cuda_sim, "FLEET_LAUNCHES"),
            (cuda_sim, "FLEET_COMPILED_SCANS"),
            (cuda_shard, "SCALE_LAUNCHES"), (cuda_shard, "FINISH_LAUNCHES"),
            (cuda_probe, "SCALE_LAUNCHES"), (cuda_probe, "BIG_LAUNCHES"),
            (cuda_pathgen, "LAUNCHES"), (cuda_solve, "PARTIALS"))
LAUNCH_COUNTS = len(COUNTERS) - 1   # the leading entries that count launches
NO_LAUNCH = (0,) * len(COUNTERS)
CACHE_SIZE = 8               # entries a user's cache keeps
DEVICES = ("cuda",)          # where programs run as graphs
CAPTURE_STREAMS: dict = {}   # device index -> the stream captures run on
BRANCH_STREAMS: dict = {}    # device index -> the stream branches run on
STREAMS: dict = {}           # (stream id, device index) -> its Stream
_ON = True                   # off inside uncaptured()


def launch_counts() -> tuple:
    """The port's kernels' launch counts, in :data:`COUNTERS`' order."""
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def expect(counts: dict) -> tuple:
    """The launches a capture must record, in :data:`COUNTERS`' order,
    from ``{(module, name): count}``; every other count 0."""
    return tuple(counts.get(c, 0) for c in COUNTERS)


def named(counts: tuple) -> str:
    """The non-zero entries of a tuple in :data:`COUNTERS`' order, as
    ``module.NAME value`` for a message."""
    return ", ".join(f"{mod.__name__.rsplit('.', 1)[1]}.{name} {v}"
                     for (mod, name), v in zip(COUNTERS, counts) if v)


@contextlib.contextmanager
def uncaptured():
    """Within the block every program runs uncaptured on the card too, the
    yardstick of the tests and the timing tools (no public keyword)."""
    global _ON
    old, _ON = _ON, False
    try:
        yield
    finally:
        _ON = old


def captures(device: torch.device) -> bool:
    """Whether programs on ``device`` run as graphs now."""
    return _ON and device.type in DEVICES


def as_tensors(inputs, device) -> list:
    """The inputs an uncaptured program takes: each Python int as a (1,)
    int64 tensor on ``device``."""
    return [torch.tensor([v], device=device) if type(v) is int else v
            for v in inputs]


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


class Branch:
    """Work forked off the current stream of ``device`` onto a side
    stream (one a device, made at its first use) and joined back; under a
    capture, a branch of the graph beside the work that follows on the
    current stream.  Each :meth:`fork` waits for the current stream's work
    so far and is kept under a slot; :meth:`wait` makes the current stream
    wait for the fork of a slot (before it overwrites what that fork
    reads), :meth:`join` for every fork.  Off the card the forks run in
    order where they are made and the waits do nothing."""

    def __init__(self, device: torch.device):
        self.card = device.type == "cuda"
        self.forks: dict = {}
        if self.card:
            self.main = torch.cuda.current_stream(device)
            self.side = BRANCH_STREAMS.get(device.index)
            if self.side is None:
                self.side = BRANCH_STREAMS[device.index] = torch.cuda.Stream(
                    device)

    @contextlib.contextmanager
    def fork(self, slot):
        """Inside the block work goes onto the side stream, after the
        current stream's work so far."""
        if not self.card:
            yield
            return
        self.side.wait_stream(self.main)
        with torch.cuda.stream(self.side):
            yield
        self.forks[slot] = self.side.record_event()

    def wait(self, slot) -> None:
        """The current stream's later work waits for the fork of ``slot``,
        if one is open."""
        done = self.forks.pop(slot, None)
        if done is not None:
            self.main.wait_event(done)

    def join(self) -> None:
        """The current stream's later work waits for every fork."""
        if self.card:
            self.main.wait_stream(self.side)
        self.forks.clear()


class Captured(NamedTuple):
    """A capture: its graph, what the program returned while it was
    captured (the tensors each replay writes again), the launches of the
    port's kernels it recorded (in :data:`COUNTERS`' order) and the
    seconds its capture and instantiation took (its ``graph.capture``
    span's)."""

    graph: "torch.cuda.CUDAGraph"
    out: Any
    recorded: tuple
    capture_s: float


def capture(program: Callable[[], Any], device: torch.device, stream,
            arrivals: bool = False) -> Captured:
    """Capture ``program()`` on :func:`capture_stream` for replay on the
    caller's ``stream``.  With ``arrivals`` the solve kernel's launches on
    the side stream take ``stream``'s arrival counters
    (``cuda_solve.counters_of``), so a replay shares them only with work
    that runs in order with it; that stream's counters must exist already
    (an uncaptured solve on it made them).  Every launch count is left as
    it was found: the capture's launches execute nothing."""
    own = capture_stream(device)
    own.wait_stream(stream)
    with spans.timed("graph.capture") as span, (
            cuda_solve.counters_of(device, stream.cuda_stream,
                                   own.cuda_stream)
            if arrivals else contextlib.nullcontext()):
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, stream=own):
                out = program()
        finally:
            recorded = tuple(a - b for a, b in zip(launch_counts(), before))
            for (mod, name), v in zip(COUNTERS, before):
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


class Entry:
    """A key's entry in a user's cache: whether its key has run once, its
    capture (:class:`Captured`), and its staged inputs: the
    :class:`HostInts` of its int slots and, a dtype each, the buffers its
    other tensors but the path are copied into."""

    def __init__(self):
        self.warm = False
        self.captured: Optional[Captured] = None

    def stage(self, inputs: tuple, path, device, stream) -> list:
        """The inputs a capture records, from the call's: the path as it
        lies, the Python ints as views of a :class:`HostInts` buffer
        (sent now), every other tensor as a clone."""
        static = list(inputs)
        self.slots = [i for i, v in enumerate(inputs) if type(v) is int]
        self.ints = None
        if self.slots:
            self.ints = HostInts(len(self.slots), device)
            self.ints.send([inputs[i] for i in self.slots], stream)
            for j, i in enumerate(self.slots):
                static[i] = self.ints.device[j:j + 1]
        groups: dict = {}
        for i, v in enumerate(inputs):
            if i != path and isinstance(v, torch.Tensor):
                static[i] = v.clone()
                dsts, idx = groups.setdefault(v.dtype, ([], []))
                dsts.append(static[i])
                idx.append(i)
        self.groups = list(groups.values())
        return static

    def copy_in(self, inputs: tuple, stream) -> None:
        """A call's inputs into the entry's buffers, in the span
        ``graph.copy_in`` when there is one to copy: the ints in one
        asynchronous copy, the other tensors but the path one launch a
        dtype (a dtype's one tensor by ``copy_``, which costs the host
        less than a ``_foreach_copy_`` of one), each skipped where the
        input is its buffer already."""
        moves = []
        for dsts, idx in self.groups:
            pairs = [(d, inputs[i]) for d, i in zip(dsts, idx)
                     if inputs[i] is not d]
            if pairs:
                moves.append(pairs)
        if self.ints is None and not moves:
            return
        with spans.span("graph.copy_in") as s:
            if self.ints is not None:
                self.ints.send([inputs[i] for i in self.slots], stream)
            for pairs in moves:
                if len(pairs) == 1:
                    pairs[0][0].copy_(pairs[0][1])
                else:
                    torch._foreach_copy_([d for d, _ in pairs],
                                         [v for _, v in pairs])
            if s:
                s.n = 8 * len(self.slots) + sum(
                    v.nbytes for pairs in moves for _, v in pairs)

    def capture(self, name: str, program: Callable, inputs: tuple, device,
                stream, launches: tuple, path, carry: bool) -> None:
        """Capture ``program`` on staged copies of ``inputs``; raise unless
        the capture recorded ``launches`` (the partials unchecked).  With
        ``carry`` the capture writes the carried outputs back into the
        buffers of the leading inputs they continue."""
        static = self.stage(inputs, path, device, stream)

        def captured():
            out = program(*static)
            if not carry:
                return out
            carried, rest = out
            for dst, src in zip(static, carried):
                if dst is not src:
                    dst.copy_(src)
            return tuple(static[:len(carried)]), rest

        c = capture(captured, device, stream, arrivals=any(launches))
        n = LAUNCH_COUNTS
        if c.recorded[:n] != launches[:n]:
            raise RuntimeError(
                f"a captured {name} recorded "
                f"{named(c.recorded) or 'no kernel launch'}, not "
                f"{named(launches) or 'no kernel launch'}")
        self.captured = c


def run(cache: OrderedDict, name: str, key: tuple, program: Callable,
        inputs: tuple, device, launches: tuple = NO_LAUNCH,
        path: Optional[int] = None, carry: bool = False):
    """``program(*inputs)`` as a CUDA graph, the entry of ``cache`` keyed
    by ``name``, the device, the caller's stream, ``key`` (what the
    program bakes in) and each input's shape and dtype, for a caller that
    has checked :func:`captures`.  ``inputs`` are tensors, None or Python
    ints, each int reaching ``program`` as a (1,) int64 tensor; nothing in
    ``program`` reads the host.  ``inputs[path]``, when given, is read
    where it lies: its address, strides, shape and dtype are in the key,
    so a path at a new address is a new key.  With ``carry`` the program
    returns (carried, rest), carried a tensor for each of its leading
    inputs, the state it leaves them in: a replay leaves it in the
    entry's buffers of those inputs and returns those buffers, so a
    caller that passes them back as the next call's inputs copies nothing
    in.

    A key's first use runs uncaptured on the caller's inputs (the span
    ``graph.warm``): it loads the kernels, raises the solve kernel's
    shared-memory limit, gives the stream its arrival counters and makes
    the eager rollout's cached constants, none of which a capture may
    do.  Its second captures on the entry's own buffers (raising unless
    the capture recorded ``launches``, :func:`expect`), and from then on
    each use copies its inputs in and replays.  Returns (the program's outputs: the uncaptured ones, or the
    graph's own as its replay leaves them; whether a graph captured
    before this call replayed)."""
    with spans.span("graph.key"):
        stream = current_stream(device)
        full = (name, device.index, stream.cuda_stream, *key, tuple(
            v if v is None else int if type(v) is int
            else (v.shape, v.dtype, v.stride(), v.data_ptr()) if i == path
            else (v.shape, v.dtype) for i, v in enumerate(inputs)))
        e = lru(cache, full, Entry, CACHE_SIZE)
    hit = e.captured is not None
    if not hit:
        if not e.warm:
            e.warm = True
            with spans.span("graph.warm"):
                return program(*as_tensors(inputs, device)), False
        e.capture(name, program, inputs, device, stream, launches, path,
                  carry)
    e.copy_in(inputs, stream)
    replay(e.captured.graph, e.captured.recorded)
    return e.captured.out, hit


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
