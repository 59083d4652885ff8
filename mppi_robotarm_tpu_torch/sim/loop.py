"""Closed-loop receding-horizon simulator.

The reference's main loop (run.py:48-71) runs one MPPI solve per step,
integrates the plant one semi-implicit Euler step at dt=0.003 (the
controller model runs at 2·dt, quirk Q2), records the state, and raises
``IndexError`` at the path end (control.py:76-78, quirk Q6).

The loops:
  * :func:`simulate` — a Python loop over :func:`sim_step`; the path end
    becomes a ``done`` flag that freezes the state.  ``backend="eager"``
    solves in PyTorch in any dtype; ``backend="cuda"`` solves each step
    through the solve kernel (``ops/cuda_solve.py``) in float32, keeping
    step, seed and waypoint index on the device so the host never waits,
    and on the card runs the steps as replayed CUDA graphs of
    ``_GRAPH_STEPS`` steps (the JAX package's one ``lax.scan``);
  * :func:`simulate_python` — the eager loop with the reference-exact
    ``IndexError``;
  * :func:`simulate_batch` — B independent scenarios (BASELINE config 4);
    on the cuda backend one kernel launch solves all B each step;
  * :func:`simulate_fused` — the whole loop in one launch of the fused
    CUDA kernel (``ops/cuda_sim.py``), float32;
  * :func:`simulate_fused_batch` — B scenarios' whole loops in one launch:
    the fleet kernel (one warp per scenario) at K <= 128, the fused kernel
    otherwise.

Without injected noise every loop draws the counter-based Philox stream
keyed by (``SimState.seed``, absolute step), so all of them see the same
noise and a chained run continues one long run's stream.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ..config import ArmParams, MPPIConfig, SimConfig
from ..device import resolve_device
from ..models.arm import arm_ddq, fk_full
from ..mppi.solver import (
    MPPIState,
    SolveResult,
    init_state,
    solve,
    solve_batched,
    step_solve_plan,
)
from ..ops import cuda_solve
from ..ops.cuda_rollout import philox_epsilon
from ..ops.cuda_sim import FLEET_MAX_SAMPLES, fused_sim_run_batched
from ..ops.weights import effective_sample_size, weight_entropy


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


def plant_step(arm: ArmParams, sim: SimConfig, q, dq, u):
    """Plant integration ``dq += dt·ddq; q += dt·dq_new`` (run.py:53-55),
    with the optional constant disturbance torque; q, dq, u (..., 2)."""
    ddq1, ddq2 = arm_ddq(q[..., 0], q[..., 1], dq[..., 0], dq[..., 1],
                         u[..., 0] + sim.disturbance[0],
                         u[..., 1] + sim.disturbance[1], arm)
    dq = dq + sim.dt * torch.stack([ddq1, ddq2], dim=-1)
    q = q + sim.dt * dq
    return q, dq


def _step_batch(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                ref_path: torch.Tensor, states: SimState,
                eps: Optional[torch.Tensor]):
    """One cuda-backend step of B scenarios: solve_batched → plant →
    freeze.  No host synchronisation: the seed and step go to the kernel
    as device tensors."""
    observed = torch.cat([states.q, states.dq], dim=-1)
    res = solve_batched(arm, cfg, ref_path, observed, states.mppi,
                        seeds=states.seed if eps is None else None, eps=eps,
                        step=states.step)
    done = states.done | res.path_end
    q_new, dq_new = plant_step(arm, sim, states.q, states.dq, res.u0)
    keep = lambda new, old: torch.where(
        done.view(-1, *(1,) * (new.dim() - 1)), old, new)
    next_states = SimState(
        step=states.step + torch.where(done, 0, 1),
        q=keep(q_new, states.q),
        dq=keep(dq_new, states.dq),
        mppi=MPPIState(u_prev=keep(res.state.u_prev, states.mppi.u_prev),
                       wp_idx=keep(res.state.wp_idx, states.mppi.wp_idx)),
        seed=states.seed,
        done=done,
    )
    return next_states, res


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


def sim_step(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
             ref_path: torch.Tensor, state: SimState,
             eps: Optional[torch.Tensor] = None, backend: str = "eager"):
    """One closed-loop step: solve → plant → freeze when done.

    Without ``eps`` the noise is the Philox stream at (seed, state.step):
    drawn on the host by the eager backend, in the kernel by the cuda one.
    Returns (next SimState, SolveResult).
    """
    if backend == "cuda":
        nxt, res = _step_batch(arm, cfg, sim, ref_path, _as_batch(state),
                               None if eps is None else eps[None])
        one = lambda v: None if v is None else v[0]
        return _scenario(nxt, 0, state.seed), SolveResult(
            *(one(v) for v in res[:2]),
            MPPIState(*(v[0] for v in res.state)),
            *(one(v) for v in res[3:]))
    if backend != "eager":
        raise ValueError(f"unknown backend {backend!r}")
    observed = torch.cat([state.q, state.dq])
    if eps is None:
        eps = philox_epsilon(state.seed, int(state.step), cfg,
                             state.q.device)
    res = solve(arm, cfg, ref_path, observed, state.mppi, eps=eps)

    done = state.done | res.path_end
    q_new, dq_new = plant_step(arm, sim, state.q, state.dq, res.u0)
    keep = lambda new, old: torch.where(done, old, new)
    next_state = SimState(
        step=state.step + torch.where(done, 0, 1),
        q=keep(q_new, state.q),
        dq=keep(dq_new, state.dq),
        mppi=MPPIState(u_prev=keep(res.state.u_prev, state.mppi.u_prev),
                       wp_idx=keep(res.state.wp_idx, state.mppi.wp_idx)),
        seed=state.seed,
        done=done,
    )
    return next_state, res


def _record(arm: ArmParams, ref_path, next_state: SimState,
            res: SolveResult, abs_step) -> tuple:
    x1, y1, x2, y2 = fk_full(next_state.q[0], next_state.q[1], arm)
    ref_row = ref_path[min(abs_step, ref_path.shape[0] - 1)]
    dn = next_state.done
    zero = lambda v: torch.where(dn, torch.zeros_like(v), v)
    return (next_state.q, next_state.dq, zero(res.u0),
            torch.stack([x2, y2]), torch.stack([x1, y1]), ref_row[0:2],
            next_state.mppi.wp_idx, zero(torch.amin(res.costs)),
            zero(torch.mean(res.costs)),
            zero(effective_sample_size(res.weights)),
            zero(weight_entropy(res.weights)), dn)


def simulate(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
             ref_path: torch.Tensor, state0: SimState, num_steps: int,
             eps_per_step=None, backend: str = "eager"):
    """Closed loop: ``num_steps`` calls of :func:`sim_step`.

    ``eps_per_step``: optional (num_steps, K, T, 2) injected noise.  Records
    after the path end carry the frozen state with zeroed u and cost lanes.
    ``backend="cuda"`` runs the loop of :func:`simulate_batch` on a batch
    of one.  Returns (final SimState, SimRecord).
    """
    if backend == "cuda":
        final, rec = simulate_batch(
            arm, cfg, sim, ref_path, _as_batch(state0), num_steps,
            eps_per_step=(None if eps_per_step is None
                          else eps_per_step[:, None]), backend="cuda")
        return (_scenario(final, 0, state0.seed),
                SimRecord(*(f[:, 0] for f in rec)))
    if backend != "eager":
        raise ValueError(f"unknown backend {backend!r}")
    state = state0
    step0 = int(state0.step)
    rows = []
    for i in range(num_steps):
        eps = None if eps_per_step is None else eps_per_step[i]
        state, res = sim_step(arm, cfg, sim, ref_path, state, eps=eps)
        rows.append(_record(arm, ref_path, state, res, step0 + i + 1))
    return state, SimRecord(*(torch.stack(f) for f in zip(*rows)))


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

    Same semantics per scenario as :func:`simulate`.  ``backend="eager"``
    runs :func:`simulate` scenario by scenario; ``backend="cuda"`` solves
    all B through one launch of the solve kernel per step, keyed by each
    scenario's constant seed and absolute step, so scenario b's run equals
    its run alone.  On CUDA tensors without ``eps_per_step`` the steps run
    as CUDA graphs of ``_GRAPH_STEPS`` steps, captured at a shape's first
    call, cached, and replayed one after the other (a failed capture
    raises); on CPU tensors, or with ``eps_per_step``, the same steps run
    eagerly, with the same bits (:func:`_step_loop`).  ``eps_per_step``:
    optional (num_steps, B, K, T, 2), step-major
    (:func:`simulate_fused_batch` takes it scenario-major, as the JAX
    package does).  Returns (final batched SimState, SimRecord of
    (num_steps, B, ...)).
    """
    if backend == "eager":
        runs = [simulate(arm, cfg, sim, ref_path,
                         _scenario(states0, b, int(states0.seed[b])),
                         num_steps, None if eps_per_step is None
                         else eps_per_step[:, b])
                for b in range(states0.q.shape[0])]
        finals = [f for f, _ in runs]
        stack = lambda vs: torch.stack(list(vs))
        final = SimState(
            step=stack(f.step for f in finals), q=stack(f.q for f in finals),
            dq=stack(f.dq for f in finals),
            mppi=MPPIState(*(stack(v) for v in zip(*(f.mppi
                                                     for f in finals)))),
            seed=states0.seed, done=stack(f.done for f in finals))
        return final, SimRecord(*(torch.stack(f, dim=1)
                                  for f in zip(*(r for _, r in runs))))
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    graphs = states0.q.device.type == "cuda" and eps_per_step is None
    return _step_loop(arm, cfg, sim, ref_path, states0, num_steps,
                      eps_per_step, graphs)


# The per-step loop on the card runs as CUDA graphs of _GRAPH_STEPS steps
# each (the last, shorter chunk as a graph of its own), replayed one after
# the other; each keeps its input state in its own buffers and leaves the
# chunk's final state there, so the next replay continues it.  16 steps gave
# the shortest 4000-step run at benchmark_preset, captures included, on an
# H100 (of 1, 8, 16, 32, 64 and 256: a replay every step costs host time,
# a longer graph more capture; PERF.md).
_GRAPH_STEPS = 16
_GRAPH_CACHE_SIZE = 8        # captured chunks kept, least recently used out
_GRAPHS: "OrderedDict" = OrderedDict()
_CAPTURE_STREAMS: dict = {}  # device index -> the stream captures run on


class _StepGraph(NamedTuple):
    """A captured chunk of ``n`` steps: its graph, the state it reads and
    leaves (seed included), its copy of the path, its (n, B, ...) record
    rows, the seconds its capture and instantiation took, and the solve
    launches the capture recorded (``n``: one a step)."""

    graph: "torch.cuda.CUDAGraph"
    state: SimState
    ref: torch.Tensor
    rows: tuple
    n: int
    capture_s: float
    launches: int


def _row_buffers(n: int, states: SimState) -> tuple:
    """Empty (n, B, ...) record rows of a batched state, in the order
    :func:`_steps_into` writes them: q, dq, u, wp_idx, cost_min,
    cost_mean, ess, entropy, done."""
    B, device = states.q.shape[0], states.q.device
    x, u = states.q.dtype, states.mppi.u_prev.dtype
    e = lambda dtype, *s: torch.empty((n, B, *s), dtype=dtype, device=device)
    return (e(x, 2), e(x, 2), e(u, 2), e(states.mppi.wp_idx.dtype),
            e(u), e(u), e(u), e(u), e(torch.bool))


def _steps_into(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                ref_path: torch.Tensor, states: SimState, eps_chunk,
                rows: tuple) -> SimState:
    """``rows[0].shape[0]`` steps of :func:`_step_batch`, step i writing its
    record row into slot i of each of ``rows`` in place; returns the last
    state.  No host synchronisation, so a CUDA graph can capture it."""
    for i in range(rows[0].shape[0]):
        eps = None if eps_chunk is None else eps_chunk[i]
        states, res = _step_batch(arm, cfg, sim, ref_path, states, eps)
        for dst, v in zip(rows, (
                states.q, states.dq, res.u0, states.mppi.wp_idx,
                torch.amin(res.costs, dim=-1), torch.mean(res.costs, dim=-1),
                effective_sample_size(res.weights),
                weight_entropy(res.weights), states.done)):
            dst[i].copy_(v)
    return states


def _state_tensors(states: SimState) -> tuple:
    return (states.step, states.q, states.dq, states.mppi.u_prev,
            states.mppi.wp_idx, states.seed, states.done)


def _as_state(t: tuple) -> SimState:
    step, q, dq, u_prev, wp_idx, seed, done = t
    return SimState(step=step, q=q, dq=dq,
                    mppi=MPPIState(u_prev=u_prev, wp_idx=wp_idx), seed=seed,
                    done=done)


def _graph_key(arm, cfg, sim, ref_path, states: SimState, n: int, stream):
    """Everything a captured chunk bakes in: the device and the caller's
    stream, the configs, the shapes and dtypes of the state and the path,
    the chunk's steps, and the solve's layout as the solver plans it now
    (so a graph captured under one plan is never replayed under
    another)."""
    device = states.q.device
    plan = step_solve_plan(cfg, states.q.shape[0], device)
    return (device.index, stream.cuda_stream, arm, cfg, sim, n, plan,
            tuple(ref_path.shape), ref_path.dtype,
            tuple((tuple(v.shape), v.dtype) for v in _state_tensors(states)))


def _capture(arm, cfg, sim, ref_path, states: SimState, n: int,
             stream) -> _StepGraph:
    """Capture :func:`_steps_into` over ``n`` steps, then the copy of its
    final state back into the input buffers, on the stream the loop owns on
    the device, for replay on the caller's ``stream``; the solves take
    ``stream``'s arrival counters (``cuda_solve.counters_of``), so a replay
    shares them only with work that runs in order with it.

    First one step runs uncaptured on the loop's stream, on scratch copies
    of the state: it loads the kernels, raises the solve kernel's
    shared-memory limit and gives ``stream`` its arrival counters, none of
    which a capture may do.  The solve launches the capture records are
    counted into the graph's ``launches`` (it raises unless that is one a
    step) and the replays add them to ``cuda_solve.LAUNCHES``; the
    warm-up's launch, and the capture's, which executes nothing, are not
    counted there."""
    device = states.q.device
    launches = cuda_solve.LAUNCHES
    own = _CAPTURE_STREAMS.get(device.index)
    if own is None:
        own = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    static = _as_state(tuple(v.clone() for v in _state_tensors(states)))
    ref = ref_path.clone()
    rows = _row_buffers(n, states)
    own.wait_stream(stream)
    with cuda_solve.counters_of(device, stream.cuda_stream, own.cuda_stream):
        with torch.cuda.stream(own):
            scratch = _as_state(tuple(v.clone()
                                      for v in _state_tensors(states)))
            _steps_into(arm, cfg, sim, ref, scratch, None,
                        tuple(r[:1].clone() for r in rows))
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        captured = cuda_solve.LAUNCHES
        with torch.cuda.graph(graph, stream=own):
            final = _steps_into(arm, cfg, sim, ref, static, None, rows)
            for dst, src in zip(_state_tensors(static),
                                _state_tensors(final)):
                if dst is not src:
                    dst.copy_(src)
        captured = cuda_solve.LAUNCHES - captured
        capture_s = time.perf_counter() - t0
    cuda_solve.LAUNCHES = launches
    if captured != n:
        raise RuntimeError(f"a captured chunk of {n} steps holds {captured} "
                           f"solve kernel launches, not one a step")
    return _StepGraph(graph, static, ref, rows, n, capture_s, captured)


def _step_graph(arm, cfg, sim, ref_path, states: SimState, n: int
                ) -> _StepGraph:
    """The cached chunk of ``n`` steps for these inputs on the current
    stream, captured at its first use."""
    stream = torch.cuda.current_stream(states.q.device)
    key = _graph_key(arm, cfg, sim, ref_path, states, n, stream)
    g = _GRAPHS.pop(key, None)
    if g is None:
        g = _capture(arm, cfg, sim, ref_path, states, n, stream)
    _GRAPHS[key] = g
    while len(_GRAPHS) > _GRAPH_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    return g


def _replay_chunks(arm, cfg, sim, ref_path, states: SimState, num_steps,
                   rows: tuple) -> SimState:
    """The run as replays of captured chunks: each chunk's input state and
    path are copied into its graph's buffers (skipped when the last replay
    was of the same graph, which left its state there), then its record
    rows out into ``rows``.  Each replay adds the solve launches its
    capture recorded to ``cuda_solve.LAUNCHES``."""
    cur = _state_tensors(states)
    last = None
    for start in range(0, num_steps, _GRAPH_STEPS):
        n = min(_GRAPH_STEPS, num_steps - start)
        g = _step_graph(arm, cfg, sim, ref_path, _as_state(cur), n)
        if g is not last:
            for dst, src in zip(_state_tensors(g.state), cur):
                dst.copy_(src)
            g.ref.copy_(ref_path)
        g.graph.replay()
        cuda_solve.LAUNCHES += g.launches
        for dst, src in zip(rows, g.rows):
            dst[start:start + n].copy_(src)
        cur, last = _state_tensors(g.state), g
    # the graphs' buffers are overwritten by their next replay
    return _as_state(tuple(v.clone() for v in cur))


def _step_loop(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
               ref_path: torch.Tensor, states0: SimState, num_steps: int,
               eps_per_step=None, graphs: bool = True):
    """:func:`simulate_batch`'s cuda backend.  With ``graphs`` (a CUDA
    state, no injected noise) the steps run as replayed CUDA graphs of
    ``_GRAPH_STEPS`` steps (:func:`_replay_chunks`); a capture or replay
    that fails raises.  Otherwise the same chunks of steps run eagerly, as
    on CPU tensors (through the solve kernel's plain twin) and with
    ``eps_per_step``, whose noise is a new input every step (up to 126 MB
    a step at 4096 × K=128, T=30), not something a graph could keep.  The
    two give the same bits.  Tests and the timing tool call this with
    ``graphs=False`` on the card to hold the graphs to the eager loop."""
    device = states0.q.device
    states = states0._replace(seed=torch.as_tensor(
        states0.seed, dtype=torch.int64, device=device))
    rows = _row_buffers(num_steps, states)
    if graphs:
        states = _replay_chunks(arm, cfg, sim, ref_path, states, num_steps,
                                rows)
    else:
        for start in range(0, num_steps, _GRAPH_STEPS):
            n = min(_GRAPH_STEPS, num_steps - start)
            states = _steps_into(
                arm, cfg, sim, ref_path, states,
                None if eps_per_step is None
                else eps_per_step[start:start + n],
                tuple(r[start:start + n] for r in rows))
    q, dq, u, wp, cmin, cmean, ess, ent, done = rows
    # the FK, reference rows and path-end zeroing of every step at once
    x1, y1, x2, y2 = fk_full(q[..., 0], q[..., 1], arm)
    idx = torch.clamp(states0.step.to(device)
                      + torch.arange(1, num_steps + 1, device=device)[:, None],
                      max=ref_path.shape[0] - 1)
    zero = lambda v: torch.where(done.view(*done.shape, *(1,) * (v.dim() - 2)),
                                 torch.zeros_like(v), v)
    return states._replace(seed=states0.seed), SimRecord(
        q=q, dq=dq, u=zero(u), ee=torch.stack([x2, y2], dim=-1),
        elbow=torch.stack([x1, y1], dim=-1), ref_xy=ref_path[idx, 0:2],
        wp_idx=wp, cost_min=zero(cmin), cost_mean=zero(cmean), ess=zero(ess),
        weight_entropy=zero(ent), done=done)


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
