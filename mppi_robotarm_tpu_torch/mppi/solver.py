"""Functional single-scenario MPPI solve, eager PyTorch.

The counterpart of ``mppi_robotarm_tpu/mppi/solver.py`` (its XLA backend).
The reference's stateful ``calc_control_input`` (control.py:67-152) becomes
a function of an explicit :class:`MPPIState`.  Quirk Q3, the in-place
aliasing of ``u_prev``, nets out to

    u_new        = u_prev + median_filter(Σₖ wₖ εₖ)
    u_prev_next  = shift_left(u_new) with the last row duplicated
    return       u_prev_next[0]   (= u_new[1] for T ≥ 2)

so the control applied to the plant is the SHIFTED first element.  The
waypoint index advances once per solve from the observed state (Q5); the
path-end condition (Q6) comes back as a ``path_end`` flag.

Two backends, as the JAX package has 'xla' and 'pallas': ``"eager"`` (the
default) rolls out in PyTorch in any dtype; ``"cuda"`` runs the waypoint
advance through the step head of ``ops/cuda_step.py`` and the K×T sweep,
the softmax, Σwε and (when ``filter_window <= 2T``) the median and update
through the solve kernels of ``ops/cuda_solve.py``, both in float32, with noise
injected or drawn in the kernel from (seed, step).  ``solve_batched`` is
the B-scenario solve through one kernel launch (``solve_batched_pallas``).
:func:`viz_rollouts` re-rolls a solve's samples and its optimal sequence
for rendering.

On the card each of the three entry points runs as one device program,
as the JAX package jits each: a CUDA graph a key (:func:`_call`), the
key's first call uncaptured, its second captured, every later one a
replay that reads the path where it lies, stages its other inputs and
hands its outputs back as fresh tensors, bit for bit the uncaptured call.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from ..config import ArmParams, MPPIConfig
from ..device import resolve_device
from ..models.arm import fk_ee
from ..ops import cuda_solve, cuda_step
from ..ops.cuda_sim import scan_width
from ..ops.filters import median_filter_reflect
from ..ops.noise import sample_epsilon, sigma_cholesky
from ..ops.rollout import rollout_costs, rollout_trajectory
from ..ops.waypoint import update_waypoint_index
from ..ops.weights import mppi_weights, ordered_sum
from ..utils import cuda_graphs, debug, spans


class MPPIState(NamedTuple):
    """Per-scenario solver state threaded through the receding-horizon loop."""

    u_prev: torch.Tensor         # (T, 2) warm-started control sequence
    wp_idx: torch.Tensor         # () int64 frozen waypoint index


class SolveResult(NamedTuple):
    u0: torch.Tensor             # (2,) control to apply now: the SHIFTED
                                 # first element, = u_seq[1] for T >= 2
    u_seq: torch.Tensor          # (T, 2) updated pre-shift sequence u_new
    state: MPPIState             # next solver state
    path_end: torch.Tensor       # () bool, the reference IndexError (Q6)
    costs: torch.Tensor          # (K,) per-sample total costs S
    weights: torch.Tensor        # (K,) importance weights w
    eps: Optional[torch.Tensor]  # (K, T, 2) the noise used; None from a
                                 # seeded cuda solve unless want_eps=True


class VizResult(NamedTuple):
    """Visualisation re-rollouts (control.py:129-145, quirk Q4)."""

    optimal_traj: torch.Tensor   # (T, 4)
    sampled_trajs: torch.Tensor  # (K, T, 4)
    sorted_idx: torch.Tensor     # (K,) argsort(S): render order (run.py:88-90)


def init_state(cfg: MPPIConfig, dtype=torch.float32,
               device=None) -> MPPIState:
    """Warm start ``u_prev = [(10, -2)] * T`` (control.py:59), index 0, on
    ``device`` (default ``cuda``; see :mod:`..device`).  The root span
    ``init_state`` (``utils/spans.py``)."""
    with spans.span("init_state"):
        device = resolve_device(device)
        u0 = torch.tensor(cfg.warm_start, dtype=dtype,
                          device=device).repeat(cfg.horizon, 1)
        return MPPIState(u_prev=u0, wp_idx=torch.tensor(
            0, dtype=torch.int64, device=device))


def shift_warm_start(u_seq: torch.Tensor) -> torch.Tensor:
    """Drop u[0] and duplicate the last row (control.py:148-149) of a
    (..., T, 2) sequence."""
    return torch.cat([u_seq[..., 1:, :], u_seq[..., -1:, :]], dim=-2)


def _median_update(u_prev, w_eps_raw, cfg: MPPIConfig):
    """u_prev + median_filter(Σwε) of a (..., T, 2) batch (Q10, Q3)."""
    w = median_filter_reflect(w_eps_raw.movedim(-2, 0), cfg.filter_window)
    return u_prev + w.movedim(0, -2)


def _solve_options(cfg: MPPIConfig) -> dict:
    """The layout options the cuda backend's solve passes to
    ``cuda_solve.solve_batched``.  With ``fuse_update`` the kernel also
    applies the median (Q10) and the u update (Q3) and returns u_new."""
    return dict(tile=None, normalize=True,
                fuse_update=cfg.filter_window <= 2 * cfg.horizon)


def step_solve_plan(cfg: MPPIConfig, batch: int, device) -> tuple:
    """The launch layout (tile, n_tiles, lanes, group) that
    ``cuda_solve._plan`` gives the cuda backend's solve of ``batch``
    scenarios of ``cfg.num_samples`` samples on ``device`` now."""
    o = _solve_options(cfg)
    return cuda_solve._plan(cfg, cfg.num_samples, o["tile"], o["normalize"],
                            o["fuse_update"], batch,
                            cuda_solve._sm_count(device))


def _solve_kernels(arm, cfg, observed_x, u_prev, window, seed, eps, step,
                   want_eps, s_out=None):
    """The cuda backend's K×T sweep for (B, ...) inputs: the kernels'
    outputs cast back to the state's dtype.  Returns (u_seq, S, eps).  The
    window's validity mask is not passed: no version of the solve reads
    it (``ops/cuda_solve.py``).  ``s_out`` (B, K) float32 takes S in
    place (``cuda_solve.solve_batched``)."""
    f32 = torch.float32
    dtype = u_prev.dtype
    opts = _solve_options(cfg)
    out, s, eps_used, _ = cuda_solve.solve_batched(
        arm, cfg, observed_x.to(f32).contiguous(),
        u_prev.to(f32).contiguous(), window.to(f32).contiguous(),
        None, seed=seed,
        eps=None if eps is None else eps.to(f32).contiguous(), step=step,
        emit_eps=want_eps or eps is not None, s_out=s_out, **opts)
    out = out.to(dtype)
    u_seq = out if opts["fuse_update"] else _median_update(u_prev, out, cfg)
    return u_seq, s.to(dtype), eps_used


# ---- the per-call graphs ----------------------------------------------------

# Each per-call entry point on the card runs as a CUDA graph a key through
# utils/cuda_graphs.py::run, the counterpart of the JAX package's jit of
# solve, solve_batched_pallas and viz_rollouts (:func:`_call`).
_CALL_GRAPHS: "OrderedDict" = OrderedDict()


@functools.lru_cache(maxsize=None)
def _solve_launches(window: int, lanes: int) -> tuple:
    """The launches a capture of the cuda backend's solve records at a
    window of ``window`` rows and ``lanes`` threads a sample (its plan,
    :func:`step_solve_plan`): its one step head and one solve kernel,
    whose window scan takes its compiled width where
    ``cuda_sim.scan_width`` says (the eager backend and the re-rollouts
    record none of the port's kernels)."""
    return cuda_graphs.expect({
        (cuda_solve, "LAUNCHES"): 1,
        (cuda_solve, "COMPILED_SCANS"): int(bool(scan_width(window, lanes))),
        (cuda_step, "HEAD_LAUNCHES"): 1})


# the per-call graphs' calls on the card: those that replayed a captured
# graph, and those that found none under their key, whose path (read
# where it lies, its address in the key) was captured anew: a key's
# uncaptured first call and its capture
REPLAYS = 0
MISSES = 0


class _Keyed:
    """A config (or arm) in a graph's key: equal to the value and hashing
    as it does, the hash computed once, at its first use; whether the
    value passed its check; and the launch plans of the cuda backend's
    solves under it (``(batch, device)`` -> plan)."""

    __slots__ = ("value", "hash", "checked", "plans")

    def __init__(self, value):
        self.value, self.hash, self.checked = value, None, False
        self.plans: dict = {}

    def __hash__(self):
        if self.hash is None:
            self.hash = hash(self.value)
        return self.hash

    def __eq__(self, other):
        return self.value == (other.value if isinstance(other, _Keyed)
                              else other)


_KEYED: dict = {}            # id(value) -> its _Keyed, the value held
_KEYED_SIZE = 64             # values kept before the table starts over


def _keyed(value, check: bool = False) -> _Keyed:
    """``value`` as a key entry, made at its first call; with ``check`` a
    config is checked by ``validate()`` until it has passed once, so an
    invalid one raises at every call."""
    k = _KEYED.get(id(value))
    if k is None or k.value is not value:
        if len(_KEYED) >= _KEYED_SIZE:
            _KEYED.clear()
        k = _KEYED[id(value)] = _Keyed(value)
    if check and not k.checked:
        value.validate()
        k.checked = True
    return k


def _plan_of(cfg: _Keyed, batch: int, device) -> tuple:
    """:func:`step_solve_plan`, computed once a (config, batch, device)."""
    plan = cfg.plans.get((batch, device))
    if plan is None:
        plan = cfg.plans[batch, device] = step_solve_plan(cfg.value, batch,
                                                          device)
    return plan


def _call(name: str, program: Callable, inputs: tuple, device,
          key: tuple, launches: tuple = cuda_graphs.NO_LAUNCH,
          path: Optional[int] = None):
    """``program(*inputs)``, on the card as a CUDA graph
    (``utils/cuda_graphs.py::run``, cache :data:`_CALL_GRAPHS`) keyed by
    ``name``, ``key`` (what the program bakes in: the configs, the
    backend, the options, the launch plan) and the inputs' shapes and
    dtypes.  ``inputs`` are tensors, None or Python ints (each reaching
    ``program`` as a (1,) int64 tensor); ``inputs[path]``, the reference
    path, the same tensor across a run, is read where it lies (a path at
    a new address is a new key).  A capture raises unless it recorded
    ``launches``.  Uncaptured on the CPU, under ``utils/debug.py::
    debug_mode`` and within ``cuda_graphs.uncaptured()``.

    The program's result is packed inside it into one flat buffer a
    dtype, and the call returns views of one clone of each
    (``cuda_graphs.Packed``, the span ``graph.clone_out``), so no later
    call changes a result handed out.  :data:`REPLAYS` and :data:`MISSES`
    count the calls that replayed and those that found no captured
    graph."""
    global REPLAYS, MISSES
    if debug.active() or not cuda_graphs.captures(device):
        return program(*cuda_graphs.as_tensors(inputs, device))
    packed, hit = cuda_graphs.run(
        _CALL_GRAPHS, name, key,
        lambda *a: cuda_graphs.Packed(program(*a)), inputs, device,
        launches, path=path)
    if hit:
        REPLAYS += 1
    else:
        MISSES += 1
    with spans.span("graph.clone_out"):
        return packed.fresh()


def _unbatch(res: SolveResult) -> SolveResult:
    """Scenario 0 of a batched result."""
    one = lambda v: None if v is None else v[0]
    return SolveResult(*(one(v) for v in res[:2]),
                       MPPIState(*(v[0] for v in res.state)),
                       *(one(v) for v in res[3:]))


def _col(v):
    """A one-element tensor as a (1,) view (None kept)."""
    return None if v is None else v.reshape(1)


def _solve_one_cuda(arm, cfg, want_eps, ref_path, observed_x, u_prev,
                    wp_idx, seed, eps, step) -> SolveResult:
    """The cuda backend's solve of one scenario: :func:`_solve_batched_
    program` on a batch of one (``wp_idx``, ``seed`` and ``step``
    one-element tensors or None)."""
    return _unbatch(_solve_batched_program(
        arm, cfg, want_eps, ref_path, observed_x[None], u_prev[None],
        _col(wp_idx), _col(seed), None if eps is None else eps[None],
        _col(step)))


def _solve_one_eager(arm, cfg, ref_path, observed_x, u_prev, wp_idx,
                     eps) -> SolveResult:
    """The eager backend's solve of one scenario, a batch of one through
    :func:`_solve_eager`: ``wp_idx`` a one-element tensor."""
    return _unbatch(_solve_eager(arm, cfg, ref_path, observed_x[None],
                                 MPPIState(u_prev[None], _col(wp_idx)),
                                 eps[None]))


def solve(
    arm: ArmParams,
    cfg: MPPIConfig,
    ref_path: torch.Tensor,       # (N, 4) [x, y, dq1, dq2]
    observed_x: torch.Tensor,     # (4,) [q1, q2, dq1, dq2]
    state: MPPIState,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    backend: str = "eager",
    seed=None,
    step=0,
    want_eps: bool = False,
) -> SolveResult:
    """One MPPI solve (control.py:67-152) in the dtype of ``state.u_prev``.

    Noise is either injected (``eps`` (K, T, 2), the parity seam) or drawn:
    from ``generator`` on the eager backend, in the kernel from the Philox
    stream at (``seed``, ``step``) on the cuda backend; exactly one source
    must be given.  A seeded cuda solve returns ``eps=None`` unless
    ``want_eps`` is set: the kernel then also writes its (K, T, 2) noise out.
    On the card the solve runs as a CUDA graph a key (:func:`_call`); the
    generator's draw happens before it, as in the uncaptured call.  A
    replay reads ``ref_path`` where it lies, sends ``seed`` and ``step``
    given as Python ints in one pinned copy (tensors are copied with the
    rest), copies the state, observation and injected noise into the
    graph, and hands back views of one clone a dtype.  The config is
    checked once (a config that fails raises at every call) and the
    launch plan computed once a config.  The call is the root span
    ``solve``, the checks and the scalars' tensors ``solve.args``
    (``utils/spans.py``).
    """
    with spans.span("solve"):
        with spans.span("solve.args"):
            if backend not in ("eager", "cuda"):
                raise ValueError(f"unknown backend {backend!r}")
            drawn = generator if backend == "eager" else seed
            if (eps is None) == (drawn is None) or (
                    backend == "cuda" and generator is not None):
                raise ValueError(
                    "provide exactly one of eps= or "
                    + ("generator=" if backend == "eager" else "seed="))
            keyed = _keyed(cfg, check=True)
            device = state.u_prev.device
            one = lambda v: v if v is None or type(v) is int else (
                torch.as_tensor(v, device=device))
            wp_idx = one(state.wp_idx)
            if backend == "cuda":
                seed, step = one(seed), one(step)

        if backend == "cuda":
            # the head's launch is one warp a scenario, from B alone
            plan = _plan_of(keyed, 1, device)
            res = _call("solve", functools.partial(_solve_one_cuda, arm, cfg,
                                                   want_eps),
                        (ref_path, observed_x, state.u_prev, wp_idx, seed,
                         eps, step), device,
                        ("cuda", _keyed(arm), keyed, want_eps,
                         drawn is not None, plan),
                        _solve_launches(cfg.search_idx_len, plan[2]), path=0)
        else:
            if eps is None:
                eps = sample_epsilon(generator, cfg.num_samples, cfg.horizon,
                                     sigma_cholesky(cfg.sigma),
                                     state.u_prev.dtype)
            res = _call("solve", functools.partial(_solve_one_eager, arm,
                                                   cfg),
                        (ref_path, observed_x, state.u_prev, wp_idx, eps),
                        device, ("eager", _keyed(arm), keyed, want_eps,
                                 drawn is not None), path=0)
        if debug.active():
            debug.check_solve("solve", res, ref_path.shape[0])
        return res


def _solve_eager(arm, cfg, ref_path, observed_x, state: MPPIState,
                 eps) -> SolveResult:
    """The eager backend's solve of B scenarios: observed_x (B, 4), u_prev
    (B, T, 2), wp_idx (B,), eps (B, K, T, 2).  Every field of the result
    leads with B; each scenario gets the bits of its solve alone (the
    same elementwise arithmetic, and sums over K in an order fixed by K,
    ``ops/weights.py::ordered_sum``).  Copies nothing from the host, so a
    CUDA graph can capture it."""
    dtype = state.u_prev.dtype
    x_obs, y_obs = fk_ee(observed_x[:, 0], observed_x[:, 1], cfg.l1, cfg.l2)
    wp_idx, window, valid = update_waypoint_index(
        ref_path, state.wp_idx, x_obs, y_obs, cfg.search_idx_len,
        cfg.dist_scale)
    eps = eps.to(dtype)
    s, _ = rollout_costs(arm, cfg, observed_x, state.u_prev, eps,
                         window.to(dtype), valid)
    w = mppi_weights(s, cfg.lam)
    # Σₖ wₖεₖ (control.py:115-118) in an order fixed by K alone: on the CPU
    # sample by sample, as the reference's NumPy does; on the card a
    # pairwise tree, where a CUDA reduction would pick its order by shape
    w_eps = ordered_sum(w[..., None, None] * eps, dim=-3)
    u_seq = _median_update(state.u_prev, w_eps, cfg)    # Q10, Q3

    next_state = MPPIState(u_prev=shift_warm_start(u_seq), wp_idx=wp_idx)
    return SolveResult(u0=next_state.u_prev[:, 0], u_seq=u_seq,
                       state=next_state,
                       path_end=wp_idx >= ref_path.shape[0] - 1, costs=s,
                       weights=w, eps=eps)


def _solve_batched_program(arm, cfg, want_eps, ref_path, observed_x, u_prev,
                           wp_idx, seeds, eps, step) -> SolveResult:
    """The cuda backend's solve of B scenarios on tensors alone: the step
    head and the solve kernel, then the weights and the warm-start
    shift."""
    _, wp_idx, path_end, window = cuda_step.step_head(
        cfg, ref_path, observed_x[:, 0:2], observed_x[:, 2:4], wp_idx)
    u_seq, s, eps = _solve_kernels(arm, cfg, observed_x, u_prev, window,
                                   seeds, eps, step, want_eps)
    next_state = MPPIState(u_prev=shift_warm_start(u_seq), wp_idx=wp_idx)
    return SolveResult(u0=next_state.u_prev[:, 0], u_seq=u_seq,
                       state=next_state, path_end=path_end, costs=s,
                       weights=mppi_weights(s, cfg.lam), eps=eps)


def solve_batched(
    arm: ArmParams,
    cfg: MPPIConfig,
    ref_path: torch.Tensor,       # (N, 4)
    observed_x: torch.Tensor,     # (B, 4)
    state: MPPIState,             # u_prev (B, T, 2), wp_idx (B,)
    seeds=None,                   # (B,) int noise seeds, or
    eps: Optional[torch.Tensor] = None,   # (B, K, T, 2) injected noise
    step=None,                    # (B,) or () int absolute closed-loop step
) -> SolveResult:
    """B-scenario solve through ONE launch of the solve kernel.

    The counterpart of the JAX package's ``solve_batched_pallas``: the
    waypoint update is ``ops/cuda_step.py::step_head`` (its kernel on the
    card), the K×T sweep one ``ops/cuda_solve.py::solve_batched`` call, the
    weights and warm-start shift batched PyTorch.  Pass
    scenario-constant ``seeds`` and the absolute ``step``: the kernel keys
    its stream by both, so no two (scenario, step) pairs share noise and a
    resumed run continues its stream.  Every field of the result has a
    leading B axis; ``eps`` is the injected noise, or None.  On the card
    the call runs as a CUDA graph a key (:func:`_call`); the call is the
    root span ``solve_batched`` (``utils/spans.py``).
    """
    with spans.span("solve_batched"):
        if (seeds is None) == (eps is None):
            raise ValueError("provide exactly one of seeds= or eps=")
        keyed = _keyed(cfg, check=True)
        device = observed_x.device
        as_dev = lambda v: v if v is None or type(v) is int else (
            torch.as_tensor(v, device=device))
        plan = _plan_of(keyed, observed_x.shape[0], device)
        return _call("solve_batched",
                     functools.partial(_solve_batched_program, arm, cfg,
                                       False),
                     (ref_path, observed_x, state.u_prev, state.wp_idx,
                      as_dev(seeds), eps, as_dev(step)), device,
                     ("cuda", _keyed(arm), keyed, seeds is not None, plan),
                     _solve_launches(cfg.search_idx_len, plan[2]), path=0)


def _viz_program(arm, cfg, observed_x, u_seq, u_prev, eps,
                 costs) -> VizResult:
    """:func:`viz_rollouts`' device part, on tensors alone."""
    k_idx = torch.arange(cfg.num_samples, device=eps.device)
    exploit = (k_idx < (1.0 - cfg.exploration) * cfg.num_samples)[:, None,
                                                                   None]
    v = torch.where(exploit, u_prev[None] + eps, eps)
    return VizResult(
        optimal_traj=rollout_trajectory(arm, cfg, observed_x, u_seq),
        sampled_trajs=rollout_trajectory(arm, cfg, observed_x, v),
        sorted_idx=torch.argsort(costs, stable=True))


def viz_rollouts(
    arm: ArmParams,
    cfg: MPPIConfig,
    observed_x: torch.Tensor,    # (4,)
    u_seq: torch.Tensor,         # (T, 2) post-update sequence
    u_prev: torch.Tensor,        # (T, 2) pre-update sequence (for v)
    eps: Optional[torch.Tensor],  # (K, T, 2)
    costs: torch.Tensor,         # (K,)
) -> VizResult:
    """Optimal and sampled trajectory re-rollouts for rendering
    (control.py:129-145, with quirk Q4).  ``v`` is rebuilt from u_prev and
    eps as in the cost rollout (control.py:98-101).  ``eps`` must be the
    solve's noise: a seeded cuda solve returns None unless asked with
    ``want_eps=True``, and this raises ``ValueError`` then.  On the card
    the call runs as a CUDA graph a key (:func:`_call`); the call is the
    root span ``viz_rollouts`` (``utils/spans.py``)."""
    with spans.span("viz_rollouts"):
        if eps is None:
            raise ValueError(
                "viz_rollouts needs the solve's noise tensor, but SolveResult"
                ".eps is None: re-run solve(..., want_eps=True) (a seeded "
                "cuda solve does not write its noise out by default)")
        return _call("viz_rollouts",
                     functools.partial(_viz_program, arm, cfg),
                     (observed_x, u_seq, u_prev, eps, costs), eps.device,
                     (_keyed(arm), _keyed(cfg)))
