"""Closed-loop receding-horizon simulator.

The reference's main loop (run.py:48-71) runs one MPPI solve per step,
integrates the plant one semi-implicit Euler step at dt=0.003 (the
controller model runs at 2·dt, quirk Q2), records the state, and raises
``IndexError`` at the path end (control.py:76-78, quirk Q6).

The loops:
  * :func:`simulate` — the per-step loop of :func:`simulate_batch` on a
    batch of one; the path end becomes a ``done`` flag that freezes the
    state;
  * :func:`simulate_python` — a loop of :func:`sim_step` with the
    reference-exact ``IndexError``;
  * :func:`simulate_batch` — B independent scenarios (BASELINE config 4),
    one set of launches a step for all B.  ``backend="eager"`` steps all
    B in batched PyTorch in any dtype (the JAX package's ``xla`` backend,
    which vmaps its step inside one ``lax.scan``); ``backend="cuda"`` runs
    each step as the solve kernel of ``ops/cuda_solve.py`` and
    ``ops/cuda_step.py``'s tail (plant, freeze, record row, the next
    step's head), after one ``cuda_step`` head a chunk, all in float32 (a
    float64 state goes through them cast and comes back float64).  Both
    keep step, seed and waypoint index on the device so the host never
    waits, and on the card run the steps as replayed CUDA graphs of a
    chunk of steps each (the JAX package's one ``lax.scan``);
  * :func:`simulate_fused` — the whole loop in one launch of the fused
    CUDA kernel (``ops/cuda_sim.py``), float32;
  * :func:`simulate_fused_batch` — B scenarios' whole loops in one launch:
    the fleet kernel (up to four warps a scenario) at K <= 128, the fused
    kernel otherwise.

Without injected noise every loop draws the counter-based Philox stream
keyed by (``SimState.seed``, absolute step), so all of them see the same
noise and a chained run continues one long run's stream.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ..config import ArmParams, MPPIConfig, SimConfig
from ..device import resolve_device
from ..models.arm import fk_full
from ..mppi.solver import (
    MPPIState,
    SolveResult,
    _solve_eager,
    _solve_kernels,
    init_state,
    solve_batched,
    step_solve_plan,
)
from ..ops import (cuda_pathgen, cuda_probe, cuda_shard, cuda_sim,
                   cuda_solve, cuda_step)
from ..ops.cuda_rollout import philox_epsilon_batch
from ..ops.cuda_sim import FLEET_MAX_SAMPLES, fused_sim_run_batched
from ..ops.cuda_step import plant_step
from ..utils import debug


class SimState(NamedTuple):
    """Full closed-loop state."""

    step: torch.Tensor           # () int64 absolute step
    q: torch.Tensor              # (2,)
    dq: torch.Tensor             # (2,)
    mppi: MPPIState
    seed: int                    # 31-bit noise seed (the JAX key's place);
                                 # a (B,) int64 tensor in a batched state
    done: torch.Tensor           # () bool path-end freeze flag (Q6)


class SimRecord(NamedTuple):
    """Per-step records mirroring run.py:39-46 (q, u, EE pos, refs)."""

    q: torch.Tensor              # (steps, 2)
    dq: torch.Tensor             # (steps, 2)
    u: torch.Tensor              # (steps, 2)
    ee: torch.Tensor             # (steps, 2)   end-effector (x2, y2)
    elbow: torch.Tensor          # (steps, 2)   (x1, y1)
    ref_xy: torch.Tensor         # (steps, 2)   ref_path[step, 0:2]
    wp_idx: torch.Tensor         # (steps,)
    cost_min: torch.Tensor       # (steps,)
    cost_mean: torch.Tensor      # (steps,)
    ess: torch.Tensor            # (steps,)
    weight_entropy: torch.Tensor  # (steps,)
    done: torch.Tensor           # (steps,) bool


def init_sim(cfg: MPPIConfig, sim: SimConfig, seed: int = 0,
             dtype=torch.float32, device=None) -> SimState:
    """Initial state: the preset's q0/dq0, the warm start, index 0, on
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    return SimState(
        step=torch.tensor(0, dtype=torch.int64, device=device),
        q=torch.tensor(sim.q0, dtype=dtype, device=device),
        dq=torch.tensor(sim.dq0, dtype=dtype, device=device),
        mppi=init_state(cfg, dtype=dtype, device=device),
        seed=int(seed) & 0x7FFFFFFF,
        done=torch.tensor(False, device=device),
    )


def init_sim_batch(cfg: MPPIConfig, sim: SimConfig, seeds, q0=None,
                   dq0=None, dtype=torch.float32, device=None) -> SimState:
    """Batched :class:`SimState` of B scenarios (BASELINE config 4).

    ``seeds``: (B,) scenario-constant noise seeds (the JAX package's keys'
    place); ``q0``/``dq0``: optional (B, 2) initial states (default: the
    preset's).  On ``device``, default ``cuda``.
    """
    device = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device)
    b = seeds.shape[0]
    rows = lambda v: torch.tensor(v, dtype=dtype, device=device).repeat(b, 1)
    return SimState(
        step=torch.zeros(b, dtype=torch.int64, device=device),
        q=rows(sim.q0) if q0 is None else torch.as_tensor(
            q0, dtype=dtype, device=device),
        dq=rows(sim.dq0) if dq0 is None else torch.as_tensor(
            dq0, dtype=dtype, device=device),
        mppi=MPPIState(
            u_prev=torch.tensor(cfg.warm_start, dtype=dtype,
                                device=device).repeat(b, cfg.horizon, 1),
            wp_idx=torch.zeros(b, dtype=torch.int64, device=device)),
        seed=seeds & 0x7FFFFFFF,
        done=torch.zeros(b, dtype=torch.bool, device=device),
    )


def _step_batch(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                ref_path: torch.Tensor, states: SimState,
                eps: Optional[torch.Tensor]):
    """One cuda-backend step of B scenarios with its SolveResult (for
    :func:`sim_step`): solve_batched (the step head and the solve kernel),
    then the step tail (plant, freeze) without a record row.  No host
    synchronisation: the seed and step go to the kernels as device
    tensors."""
    observed = torch.cat([states.q, states.dq], dim=-1)
    res = solve_batched(arm, cfg, ref_path, observed, states.mppi,
                        seeds=states.seed if eps is None else None, eps=eps,
                        step=states.step)
    step, q, dq, u_prev, wp, done, _ = cuda_step.step_tail(
        arm, cfg, sim, ref_path, *_state_tensors(states)[:5], states.done,
        res.state.wp_idx, res.path_end, res.u_seq, res.costs)
    return _as_state((step, q, dq, u_prev, wp, states.seed, done)), res


def _as_batch(state: SimState) -> SimState:
    """A single-scenario state as a batch of one (seed on the device)."""
    device = state.q.device
    return SimState(
        step=state.step.reshape(1), q=state.q[None], dq=state.dq[None],
        mppi=MPPIState(u_prev=state.mppi.u_prev[None],
                       wp_idx=state.mppi.wp_idx.reshape(1)),
        seed=torch.tensor([state.seed], dtype=torch.int64, device=device),
        done=state.done.reshape(1))


def _scenario(states: SimState, b: int, seed) -> SimState:
    """Scenario ``b`` of a batched state, with the given ``seed``."""
    return SimState(
        step=states.step[b], q=states.q[b], dq=states.dq[b],
        mppi=MPPIState(u_prev=states.mppi.u_prev[b],
                       wp_idx=states.mppi.wp_idx[b]),
        seed=seed, done=states.done[b])


def _eager_step(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                ref_path: torch.Tensor, states: SimState,
                eps: Optional[torch.Tensor], clock=None, row=None):
    """One eager-backend step of B scenarios, the JAX package's
    ``sim_step`` vmapped: the batched solve, then the torch code of the
    cuda backend's step tail (``cuda_step.step_tail_plain``: freeze,
    warm-start shift, plant, and with ``clock`` the step's record row
    written into ``row``).  Without ``eps`` the noise is the Philox stream
    at each scenario's (seed, step), keyed from the device tensors.  No
    host read and no copy from the host, so a CUDA graph can capture it.
    Returns (next state, SolveResult, clock + 1 or None)."""
    if eps is None:
        eps = philox_epsilon_batch(states.seed, states.step,
                                   torch.zeros_like(states.step),
                                   cfg.num_samples, cfg)
    res = _solve_eager(arm, cfg, ref_path,
                       torch.cat([states.q, states.dq], dim=-1),
                       states.mppi, eps)
    *nxt, clock = cuda_step.step_tail_plain(
        arm, cfg, sim, ref_path, *_state_tensors(states)[:5], states.done,
        res.state.wp_idx, res.path_end, res.u_seq, res.costs, clock, row)
    return _as_state((*nxt[:5], states.seed, nxt[5])), res, clock


def sim_step(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
             ref_path: torch.Tensor, state: SimState,
             eps: Optional[torch.Tensor] = None, backend: str = "eager"):
    """One closed-loop step: solve → plant → freeze when done.

    Without ``eps`` the noise is the Philox stream at (seed, state.step):
    drawn in batched PyTorch by the eager backend, in the kernel by the
    cuda one.  Both run their loop's step on a batch of one.  Returns
    (next SimState, SolveResult).
    """
    if backend not in ("eager", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    batch, eps = _as_batch(state), None if eps is None else eps[None]
    if backend == "cuda":
        nxt, res = _step_batch(arm, cfg, sim, ref_path, batch, eps)
    else:
        nxt, res, _ = _eager_step(arm, cfg, sim, ref_path, batch, eps)
    one = lambda v: None if v is None else v[0]
    return _scenario(nxt, 0, state.seed), SolveResult(
        *(one(v) for v in res[:2]), MPPIState(*(v[0] for v in res.state)),
        *(one(v) for v in res[3:]))


def simulate(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
             ref_path: torch.Tensor, state0: SimState, num_steps: int,
             eps_per_step=None, backend: str = "eager"):
    """Closed loop of ``num_steps`` steps: the loop of
    :func:`simulate_batch` on a batch of one, either backend.

    ``eps_per_step``: optional (num_steps, K, T, 2) injected noise.  Records
    after the path end carry the frozen state with zeroed u and cost lanes.
    Returns (final SimState, SimRecord).
    """
    if backend not in ("eager", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    final, rec = simulate_batch(
        arm, cfg, sim, ref_path, _as_batch(state0), num_steps,
        eps_per_step=(None if eps_per_step is None
                      else eps_per_step[:, None]), backend=backend)
    return (_scenario(final, 0, state0.seed),
            SimRecord(*(f[:, 0] for f in rec)))


def simulate_python(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                    ref_path: torch.Tensor, state0: SimState,
                    num_steps: int, eps_per_step=None):
    """Host loop with reference-exact error behaviour: raises
    ``IndexError`` at the path end like control.py:76-78.

    Returns (final SimState, [(q, dq, u0, wp_idx) per step]).
    """
    state = state0
    records = []
    for i in range(num_steps):
        eps = None if eps_per_step is None else eps_per_step[i]
        state, res = sim_step(arm, cfg, sim, ref_path, state, eps=eps)
        if bool(state.done):
            raise IndexError("Reached the end of the reference path.")
        records.append((state.q.clone(), state.dq.clone(), res.u0.clone(),
                        int(state.mppi.wp_idx)))
    return state, records


def simulate_batch(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                   ref_path: torch.Tensor, states0: SimState,
                   num_steps: int, eps_per_step=None,
                   backend: str = "eager"):
    """B independent closed-loop scenarios; ``states0`` from
    :func:`init_sim_batch`.

    Same semantics per scenario as the JAX package's ``sim_step``, and one
    set of launches a step for all B, keyed by each scenario's constant
    seed and absolute step, so scenario b's run equals its run alone (bit
    for bit on the CPU).  ``backend="eager"`` steps in batched PyTorch in
    the state's dtype (:func:`_eager_step`); ``backend="cuda"`` solves all
    B through one launch of the solve kernel per step.  On CUDA tensors
    without ``eps_per_step`` the steps run as CUDA graphs of a chunk of
    steps each (:func:`_chunk_steps`), captured at a shape's first call,
    cached, and replayed one after the other (a failed capture raises); on
    CPU tensors, with ``eps_per_step``, or for the eager backend under
    ``utils/debug.py::debug_mode``, the same chunks run uncaptured, with
    the same bits (:func:`_step_loop`).  ``eps_per_step``: optional
    (num_steps, B, K, T, 2), step-major (:func:`simulate_fused_batch`
    takes it scenario-major, as the JAX package does).  Returns (final
    batched SimState, SimRecord of (num_steps, B, ...)).
    """
    if backend not in ("eager", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    graphs = (states0.q.device.type == "cuda" and eps_per_step is None
              and (backend == "cuda" or not debug.active()))
    return _step_loop(arm, cfg, sim, ref_path, states0, num_steps,
                      eps_per_step, graphs, backend)


# The per-step loop on the card runs as CUDA graphs of a chunk of steps
# each (the last, shorter chunk as a graph of its own), replayed one after
# the other; each keeps its input state in its own buffers and leaves the
# chunk's final state there, so the next replay continues it.  The cuda
# backend's chunks are _GRAPH_STEPS steps: 16 gave the shortest 4000-step
# run at benchmark_preset, captures included, on an H100 (of 1, 8, 16, 32,
# 64 and 256: a replay every step costs host time, a longer graph more
# capture; PERF.md).  The eager backend's chunk, _EAGER_GRAPH_STEPS, is one
# step: its ~5,900 launches a step keep the card busy whatever the chunk,
# and of 1, 4 and 16 steps one captured fastest (0.24-0.27 s against
# 0.61-0.69 and 2.7-3.7) for the same replay rate, 6.88-6.95 ms a step at
# benchmark_preset on an H100 (tools/eager_loop.py --chunks; PERF.md).
_GRAPH_STEPS = 16
_EAGER_GRAPH_STEPS = 1
_GRAPH_CACHE_SIZE = 8        # captured chunks kept, least recently used out
_GRAPHS: "OrderedDict" = OrderedDict()
_CAPTURE_STREAMS: dict = {}  # device index -> the stream captures run on
# every launch count of the port's kernels, as (module, name)
_COUNTERS = ((cuda_solve, "LAUNCHES"), (cuda_step, "HEAD_LAUNCHES"),
             (cuda_step, "TAIL_LAUNCHES"), (cuda_step, "CARRIED_HEADS"),
             (cuda_sim, "LAUNCHES"), (cuda_sim, "FLEET_LAUNCHES"),
             (cuda_shard, "SCALE_LAUNCHES"), (cuda_shard, "FINISH_LAUNCHES"),
             (cuda_probe, "SCALE_LAUNCHES"), (cuda_probe, "BIG_LAUNCHES"),
             (cuda_pathgen, "LAUNCHES"))


def _chunk_steps(backend: str) -> int:
    """Steps a chunk of the per-step loop holds on ``backend``."""
    return _GRAPH_STEPS if backend == "cuda" else _EAGER_GRAPH_STEPS


class _StepGraph(NamedTuple):
    """A captured chunk of ``n`` steps: its graph, the state it reads and
    leaves (seed included) and the run's step counter (the loop's
    ``clock``), its copy of the path, its (n, B, ...) record rows, the
    seconds its capture and instantiation took, and the launches the
    capture recorded: the solve kernel's (``launches``, one a step) and
    the step kernels' (``step_launches``: one head, a tail a step, and the
    n - 1 tails that carried the next head); an eager chunk's are all 0."""

    graph: "torch.cuda.CUDAGraph"
    state: SimState
    clock: torch.Tensor
    ref: torch.Tensor
    rows: tuple
    n: int
    capture_s: float
    launches: int
    step_launches: tuple


def _row_buffers(n: int, states: SimState, ref_path: torch.Tensor) -> tuple:
    """Empty (n, B, ...) record rows of a batched state, one a field of
    :class:`SimRecord` and in its order, in the dtypes of the state's
    fields and the path (each step writes its row)."""
    B, device = states.q.shape[0], states.q.device
    x, u = states.q.dtype, states.mppi.u_prev.dtype
    e = lambda dtype, *s: torch.empty((n, B, *s), dtype=dtype, device=device)
    return (e(x, 2), e(x, 2), e(u, 2), e(x, 2), e(x, 2),
            e(ref_path.dtype, 2), e(states.mppi.wp_idx.dtype), e(u), e(u),
            e(u), e(u), e(torch.bool))


def _steps_into(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                ref_path: torch.Tensor, states: SimState,
                clock: torch.Tensor, eps_chunk, rows: tuple):
    """The cuda backend's ``rows[0].shape[0]`` steps: the step head of the
    first, then each step the solve kernel and the step tail, which
    carries the next step's head but on the last step; step i writes its
    record row into slot i of each of ``rows`` in place; ``clock`` is the
    run's step counter (the reference rows' index).  Returns the last
    state and clock.  No host synchronisation, so a CUDA graph can
    capture it."""
    n = rows[0].shape[0]
    head = cuda_step.step_head(cfg, ref_path, states.q, states.dq,
                               states.mppi.wp_idx)
    for i in range(n):
        eps = None if eps_chunk is None else eps_chunk[i]
        x0, wp, path_end, window = head
        u_seq, s, _ = _solve_kernels(
            arm, cfg, x0, states.mppi.u_prev, window,
            states.seed if eps is None else None, eps, states.step, False)
        carry = i + 1 < n
        out = cuda_step.step_tail(
            arm, cfg, sim, ref_path, *_state_tensors(states)[:5],
            states.done, wp, path_end, u_seq, s, clock,
            tuple(r[i] for r in rows), carry_head=carry)
        step, q, dq, u_prev, wp, done, clock = out[:7]
        head = out[7] if carry else None
        states = _as_state((step, q, dq, u_prev, wp, states.seed, done))
    return states, clock


def _eager_steps_into(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                      ref_path: torch.Tensor, states: SimState,
                      clock: torch.Tensor, eps_chunk, rows: tuple):
    """The eager backend's twin of :func:`_steps_into`, with the same
    arguments: ``rows[0].shape[0]`` steps of :func:`_eager_step`, step i
    writing its record row into slot i of each of ``rows`` in place.
    Returns the last state and clock.  No host read and no copy from the
    host, so a CUDA graph can capture it."""
    for i in range(rows[0].shape[0]):
        states, _, clock = _eager_step(
            arm, cfg, sim, ref_path, states,
            None if eps_chunk is None else eps_chunk[i], clock,
            tuple(r[i] for r in rows))
    return states, clock


def _body(backend: str):
    """The chunk body of ``backend``'s per-step loop."""
    return _steps_into if backend == "cuda" else _eager_steps_into


def _state_tensors(states: SimState) -> tuple:
    return (states.step, states.q, states.dq, states.mppi.u_prev,
            states.mppi.wp_idx, states.seed, states.done)


def _as_state(t: tuple) -> SimState:
    step, q, dq, u_prev, wp_idx, seed, done = t
    return SimState(step=step, q=q, dq=dq,
                    mppi=MPPIState(u_prev=u_prev, wp_idx=wp_idx), seed=seed,
                    done=done)


def _launch_counts() -> tuple:
    """The port's kernels' launch counts, in :data:`_COUNTERS`' order."""
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _graph_key(arm, cfg, sim, ref_path, states: SimState, n: int, stream,
               backend: str = "cuda"):
    """Everything a captured chunk bakes in: the backend, the device and
    the caller's stream, the configs, the shapes and dtypes of the state
    and the path, the chunk's steps, and for the cuda backend the solve's
    and the step tail's layouts as the solver and ``cuda_step`` plan them
    now (so a graph captured under one plan is never replayed under
    another)."""
    device = states.q.device
    B = states.q.shape[0]
    plan = ((step_solve_plan(cfg, B, device),
             cuda_step._tail_layout_on(cfg.num_samples, B, device))
            if backend == "cuda" else None)
    return (backend, device.index, stream.cuda_stream, arm, cfg, sim, n,
            plan, tuple(ref_path.shape), ref_path.dtype,
            tuple((tuple(v.shape), v.dtype) for v in _state_tensors(states)))


def _chunk(body, arm, cfg, sim, ref, states: SimState, clock, rows):
    """A captured chunk's program: ``body``'s steps on the graph's
    buffers, then its final state and clock copied back into them, so the
    next replay continues the run."""
    final, final_clock = body(arm, cfg, sim, ref, states, clock, None, rows)
    for dst, src in zip((*_state_tensors(states), clock),
                        (*_state_tensors(final), final_clock)):
        if dst is not src:
            dst.copy_(src)


def _capture(arm, cfg, sim, ref_path, states: SimState, n: int, stream,
             clock=None, backend: str = "cuda") -> _StepGraph:
    """Capture ``backend``'s chunk of ``n`` steps (:func:`_chunk` of
    :func:`_body`) on the stream the loop owns on the device, for replay
    on the caller's ``stream``; the cuda backend's solves take
    ``stream``'s arrival counters (``cuda_solve.counters_of``), so a
    replay shares them only with work that runs in order with it.

    First one step runs uncaptured on the loop's stream, on scratch copies
    of the state: it loads the kernels, raises the solve kernel's
    shared-memory limit, gives ``stream`` its arrival counters and makes
    the eager rollout's cached constants, none of which a capture may do.
    The launches the capture records are counted into the graph: a cuda
    chunk raises unless they are a solve and a tail a step, one head, and
    n - 1 tails that carried the head; an eager chunk raises on any launch
    of the port's kernels.  The replays add them to ``cuda_solve.LAUNCHES``
    and ``cuda_step``'s counts; the warm-up's launches, and the capture's,
    which execute nothing, are not counted there.  ``clock`` is the run's
    step counter at the chunk's start (default: the state's step)."""
    device = states.q.device
    clock = states.step if clock is None else clock
    body = _body(backend)
    counts = _launch_counts()
    own = _CAPTURE_STREAMS.get(device.index)
    if own is None:
        own = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    static = _as_state(tuple(v.clone() for v in _state_tensors(states)))
    static_clock = clock.clone()
    ref = ref_path.clone()
    rows = _row_buffers(n, states, ref_path)
    own.wait_stream(stream)
    arrivals = (cuda_solve.counters_of(device, stream.cuda_stream,
                                       own.cuda_stream)
                if backend == "cuda" else contextlib.nullcontext())
    with arrivals:
        with torch.cuda.stream(own):
            scratch = _as_state(tuple(v.clone()
                                      for v in _state_tensors(states)))
            body(arm, cfg, sim, ref, scratch, clock.clone(), None,
                 tuple(r[:1].clone() for r in rows))
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, stream=own):
            _chunk(body, arm, cfg, sim, ref, static, static_clock, rows)
        recorded = tuple(a - b for a, b in zip(_launch_counts(), before))
        capture_s = time.perf_counter() - t0
    for (mod, name), v in zip(_COUNTERS, counts):
        setattr(mod, name, v)
    captured, step_captured = recorded[0], recorded[1:4]
    if backend != "cuda":
        if any(recorded):
            raise RuntimeError(
                f"a captured eager chunk of {n} steps launched the port's "
                f"kernels: " + ", ".join(
                    f"{mod.__name__.rsplit('.', 1)[1]}.{name} {v}"
                    for (mod, name), v in zip(_COUNTERS, recorded) if v))
    elif captured != n:
        raise RuntimeError(f"a captured chunk of {n} steps holds {captured} "
                           f"solve kernel launches, not one a step")
    elif step_captured != (1, n, n - 1):
        raise RuntimeError(f"a captured chunk of {n} steps holds "
                           f"{step_captured} step head, tail and carried "
                           f"head launches, not (1, {n}, {n - 1})")
    return _StepGraph(graph, static, static_clock, ref, rows, n, capture_s,
                      captured, step_captured)


def _step_graph(arm, cfg, sim, ref_path, states: SimState, clock, n: int,
                backend: str = "cuda") -> _StepGraph:
    """The cached chunk of ``n`` steps of ``backend`` for these inputs on
    the current stream, captured at its first use."""
    stream = torch.cuda.current_stream(states.q.device)
    key = _graph_key(arm, cfg, sim, ref_path, states, n, stream, backend)
    g = _GRAPHS.pop(key, None)
    if g is None:
        g = _capture(arm, cfg, sim, ref_path, states, n, stream, clock,
                     backend)
    _GRAPHS[key] = g
    while len(_GRAPHS) > _GRAPH_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    return g


def _replay_chunks(arm, cfg, sim, ref_path, states: SimState, clock,
                   num_steps, rows: tuple, backend: str = "cuda"
                   ) -> SimState:
    """The run as replays of captured chunks: each chunk's input state,
    clock and path are copied into its graph's buffers (skipped when the
    last replay was of the same graph, which left its state there), then
    its record rows out into ``rows``.  Each replay adds the launches its
    capture recorded to ``cuda_solve.LAUNCHES`` and ``cuda_step``'s
    counts.  Under ``utils/debug.py::debug_mode`` each chunk's state is
    checked after its replay, outside the graph."""
    cur = (*_state_tensors(states), clock)
    last = None
    S = _chunk_steps(backend)
    for start in range(0, num_steps, S):
        n = min(S, num_steps - start)
        g = _step_graph(arm, cfg, sim, ref_path, _as_state(cur[:7]), cur[7],
                        n, backend)
        if g is not last:
            for dst, src in zip((*_state_tensors(g.state), g.clock), cur):
                dst.copy_(src)
            g.ref.copy_(ref_path)
        before = (_as_state(tuple(v.clone() for v in cur[:7]))
                  if debug.active() else None)
        g.graph.replay()
        cuda_solve.LAUNCHES += g.launches
        cuda_step.HEAD_LAUNCHES += g.step_launches[0]
        cuda_step.TAIL_LAUNCHES += g.step_launches[1]
        cuda_step.CARRIED_HEADS += g.step_launches[2]
        for dst, src in zip(rows, g.rows):
            dst[start:start + n].copy_(src)
        cur, last = (*_state_tensors(g.state), g.clock), g
        if before is not None:
            debug.check_step("simulate_batch (graph chunk)", before,
                             g.state, ref_path.shape[0], n, u=g.rows[2])
    # the graphs' buffers are overwritten by their next replay
    return _as_state(tuple(v.clone() for v in cur[:7]))


def _step_loop(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
               ref_path: torch.Tensor, states0: SimState, num_steps: int,
               eps_per_step=None, graphs: bool = True,
               backend: str = "cuda"):
    """:func:`simulate_batch`'s loop on ``backend``, in chunks of
    :func:`_chunk_steps` steps.  With ``graphs`` (a CUDA state, no
    injected noise) the chunks run as replayed CUDA graphs
    (:func:`_replay_chunks`); a capture or replay that fails raises.
    Otherwise the same chunks run uncaptured, as on CPU tensors and with
    ``eps_per_step``, whose noise is a new input every step (up to 126 MB
    a step at 4096 × K=128, T=30), not something a graph could keep.  The
    two give the same bits.  Tests and the timing tools call this with
    ``graphs=False`` on the card to hold the graphs to the uncaptured
    loop."""
    device = states0.q.device
    states = states0._replace(seed=torch.as_tensor(
        states0.seed, dtype=torch.int64, device=device))
    # the run's step counter: step i's reference row is step0 + i + 1
    clock = states0.step.to(device).clone()
    rows = _row_buffers(num_steps, states, ref_path)
    if graphs:
        states = _replay_chunks(arm, cfg, sim, ref_path, states, clock,
                                num_steps, rows, backend)
    else:
        S, body = _chunk_steps(backend), _body(backend)
        for start in range(0, num_steps, S):
            n = min(S, num_steps - start)
            before = states
            states, clock = body(
                arm, cfg, sim, ref_path, states, clock,
                None if eps_per_step is None
                else eps_per_step[start:start + n],
                tuple(r[start:start + n] for r in rows))
            if debug.active():
                debug.check_step("simulate_batch (chunk)", before, states,
                                 ref_path.shape[0], n,
                                 u=rows[2][start:start + n])
    return states._replace(seed=states0.seed), SimRecord(*rows)


# A launch writes 48 B of kernel rows per scenario-step, which the
# SimRecord's fields are then cut from.  One launch covers at most 2^20
# scenario-steps (48 MiB of rows); a longer run is chained through the
# returned state and each chunk's fields go straight into a preallocated
# record, so the run holds its record plus one chunk's rows, and the
# (seed, absolute step) noise indexing makes it equal to one launch bit
# for bit.
_FUSED_MAX_STEPS = 1 << 20


def simulate_fused(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                   ref_path: torch.Tensor, state0: SimState, num_steps: int,
                   eps_per_step: Optional[torch.Tensor] = None):
    """Closed loop with the WHOLE loop in one fused kernel launch.

    Waypoint update, noise, rollout, softmax, median, control update, plant
    step and record writes all run inside ``csrc/sim_kernel.cu`` on CUDA
    tensors (the plain PyTorch twin on CPU tensors), in float32: the
    :func:`simulate_fused_batch` of a batch of one.  Semantics match
    :func:`simulate`.  ``eps_per_step``: optional (num_steps, K, T, 2)
    injected noise; by default the kernel draws the Philox stream keyed by
    (state0.seed, absolute step).  The seed is returned unchanged and
    ``step`` advances by the steps that were not done, so a run chained
    from the returned state continues the stream bit for bit.  Runs longer
    than ``_FUSED_MAX_STEPS`` (a bound on a launch's kernel rows) are
    chained the same way.
    """
    final, rec = simulate_fused_batch(
        arm, cfg, sim, ref_path, _as_batch(state0), num_steps,
        eps_per_step=None if eps_per_step is None else eps_per_step[None],
        group=1)
    return (_scenario(final, 0, state0.seed),
            SimRecord(*(f[:, 0] for f in rec)))


def auto_group(cfg: MPPIConfig, batch: int) -> int:
    """The JAX package's choice of scenarios per program: the largest of 8,
    4, 2, 1 that divides ``batch`` when K <= 128, else 1."""
    if cfg.num_samples > FLEET_MAX_SAMPLES:
        return 1
    return next(g for g in (8, 4, 2, 1) if batch % g == 0)


def simulate_fused_batch(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                         ref_path: torch.Tensor, states0: SimState,
                         num_steps: int,
                         eps_per_step: Optional[torch.Tensor] = None,
                         group: Optional[int] = None):
    """B scenarios × the whole closed loop, one kernel launch per chunk.

    ``states0`` from :func:`init_sim_batch`; each scenario draws the Philox
    stream keyed by its ``seed`` and absolute ``step``.  ``group`` is the
    number of scenarios per block (None: :func:`auto_group`).  On CUDA
    tensors ``1 < group <= 8`` at K <= 128 runs ``csrc/fleet_kernel.cu``,
    any other ``group`` ``csrc/sim_kernel.cu``; on CPU tensors the plain
    versions run.  Every route gives each scenario the bits of its
    :func:`simulate_fused` run alone.  ``eps_per_step``: optional
    (B, num_steps, K, T, 2), scenario-major as in the JAX package (unlike
    :func:`simulate_batch`'s (num_steps, B, ...)).  Records are laid out
    (num_steps, B, ...) as :func:`simulate_batch`'s; the final ``step``
    advances by each scenario's live steps and the seeds come back
    unchanged, so a chained run continues the streams.  Runs of more than
    ``_FUSED_MAX_STEPS`` scenario-steps are launched in chunks chained that
    way, each written into one preallocated record: the result equals one
    launch bit for bit.
    """
    B = states0.q.shape[0]
    if group is None:
        group = auto_group(cfg, B)
    device = ref_path.device
    f32 = torch.float32
    ref = ref_path.to(f32).contiguous()
    seeds = torch.as_tensor(states0.seed, dtype=torch.int64, device=device)
    step0 = torch.as_tensor(states0.step, dtype=torch.int64, device=device)
    q, dq = states0.q.to(f32).contiguous(), states0.dq.to(f32).contiguous()
    u, wp = states0.mppi.u_prev.to(f32).contiguous(), states0.mppi.wp_idx
    step = step0
    done = torch.as_tensor(states0.done, dtype=torch.bool, device=device)
    chunk = max(1, _FUSED_MAX_STEPS // max(B, 1))
    rec = None if 0 < num_steps <= chunk else _empty_record(num_steps, B,
                                                            device)
    for start in range(0, num_steps, chunk):
        n = min(chunk, num_steps - start)
        before = (step, q, dq, u, wp, seeds, done)
        rows, u = fused_sim_run_batched(
            arm, cfg, sim, ref, q, dq, u, wp, seeds, n,
            eps=(None if eps_per_step is None else
                 eps_per_step[:, start:start + n].to(f32).contiguous()),
            step0=step, group=group)
        r = rows.transpose(0, 1)            # (n, B, 12)
        part = _record_from_rows(arm, ref, step0, start, r)
        if rec is None:
            rec = part
        else:
            for dst, src in zip(rec, part):
                dst[start:start + n] = src
        q, dq = r[-1, :, 0:2].contiguous(), r[-1, :, 2:4].contiguous()
        wp, done = part.wp_idx[-1], part.done[-1]
        step = step + torch.sum(~part.done, dim=0)
        if debug.active():
            debug.check_step("simulate_fused_batch (launch)",
                             _as_state(before),
                             _as_state((step, q, dq, u, wp, seeds, done)),
                             ref.shape[0], n, u=part.u)
    final = SimState(step=step, q=q, dq=dq,
                     mppi=MPPIState(u_prev=u, wp_idx=wp),
                     seed=states0.seed, done=done)
    return final, rec


def _empty_record(steps: int, B: int, device) -> SimRecord:
    f = lambda *s: torch.empty((steps, B, *s), dtype=torch.float32,
                               device=device)
    return SimRecord(
        q=f(2), dq=f(2), u=f(2), ee=f(2), elbow=f(2), ref_xy=f(2),
        wp_idx=torch.empty((steps, B), dtype=torch.int64, device=device),
        cost_min=f(), cost_mean=f(), ess=f(), weight_entropy=f(),
        done=torch.empty((steps, B), dtype=torch.bool, device=device))


def _record_from_rows(arm: ArmParams, ref: torch.Tensor, step0: torch.Tensor,
                      start: int, r: torch.Tensor) -> SimRecord:
    """The SimRecord of a launch's (n, B, 12) kernel rows that begin
    ``start`` steps after ``step0``: the reference row of step i is
    ``step0 + start + i + 1``, as in one launch over the whole run."""
    q = r[..., 0:2]
    x1, y1, x2, y2 = fk_full(q[..., 0], q[..., 1], arm)
    idx = torch.clamp(
        step0[None] + torch.arange(start + 1, start + r.shape[0] + 1,
                                   device=r.device)[:, None],
        max=ref.shape[0] - 1)
    return SimRecord(
        q=q, dq=r[..., 2:4], u=r[..., 4:6],
        ee=torch.stack([x2, y2], dim=-1), elbow=torch.stack([x1, y1], dim=-1),
        ref_xy=ref[idx, 0:2], wp_idx=r[..., 6].long(),
        cost_min=r[..., 8], cost_mean=r[..., 9], ess=r[..., 10],
        weight_entropy=r[..., 11], done=r[..., 7] > 0.5)
