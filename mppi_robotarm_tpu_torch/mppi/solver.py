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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ArmParams, MPPIConfig
from ..device import resolve_device
from ..models.arm import fk_ee
from ..ops import cuda_solve, cuda_step
from ..ops.filters import median_filter_reflect
from ..ops.noise import sample_epsilon, sigma_cholesky
from ..ops.rollout import rollout_costs, rollout_trajectory
from ..ops.waypoint import update_waypoint_index
from ..ops.weights import mppi_weights, ordered_sum
from ..utils import debug


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
    ``device`` (default ``cuda``; see :mod:`..device`)."""
    device = resolve_device(device)
    u0 = torch.tensor(cfg.warm_start, dtype=dtype,
                      device=device).repeat(cfg.horizon, 1)
    return MPPIState(u_prev=u0,
                     wp_idx=torch.tensor(0, dtype=torch.int64, device=device))


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
                   want_eps):
    """The cuda backend's K×T sweep for (B, ...) inputs: the kernels'
    outputs cast back to the state's dtype.  Returns (u_seq, S, eps).  The
    window's validity mask is not passed: no version of the solve reads
    it (``ops/cuda_solve.py``)."""
    f32 = torch.float32
    dtype = u_prev.dtype
    opts = _solve_options(cfg)
    out, s, eps_used, _ = cuda_solve.solve_batched(
        arm, cfg, observed_x.to(f32).contiguous(),
        u_prev.to(f32).contiguous(), window.to(f32).contiguous(),
        None, seed=seed,
        eps=None if eps is None else eps.to(f32).contiguous(), step=step,
        emit_eps=want_eps or eps is not None, **opts)
    out = out.to(dtype)
    u_seq = out if opts["fuse_update"] else _median_update(u_prev, out, cfg)
    return u_seq, s.to(dtype), eps_used


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
    """
    if backend not in ("eager", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    drawn = generator if backend == "eager" else seed
    if (eps is None) == (drawn is None) or (
            backend == "cuda" and generator is not None):
        raise ValueError("provide exactly one of eps= or "
                         + ("generator=" if backend == "eager" else "seed="))
    cfg.validate()
    device = state.u_prev.device

    if backend == "cuda":
        # a batch of one through the step head and the solve kernel
        one = lambda v: None if v is None else torch.as_tensor(
            v, device=device).reshape(1)
        _, wp_idx, path_end, window = cuda_step.step_head(
            cfg, ref_path, observed_x[None, 0:2], observed_x[None, 2:4],
            one(state.wp_idx))
        u_seq, s, eps = _solve_kernels(
            arm, cfg, observed_x[None], state.u_prev[None], window,
            one(seed), None if eps is None else eps[None], one(step),
            want_eps)
        u_seq, s = u_seq[0], s[0]
        next_state = MPPIState(u_prev=shift_warm_start(u_seq),
                               wp_idx=wp_idx[0])
        res = SolveResult(u0=next_state.u_prev[0], u_seq=u_seq,
                          state=next_state, path_end=path_end[0], costs=s,
                          weights=mppi_weights(s, cfg.lam),
                          eps=None if eps is None else eps[0])
    else:
        if eps is None:
            eps = sample_epsilon(generator, cfg.num_samples, cfg.horizon,
                                 sigma_cholesky(cfg.sigma),
                                 state.u_prev.dtype)
        # a batch of one through the eager loop's batched solve
        one = _solve_eager(arm, cfg, ref_path, observed_x[None],
                           MPPIState(state.u_prev[None], torch.as_tensor(
                               state.wp_idx, device=device).reshape(1)),
                           eps[None])
        res = SolveResult(*(v[0] for v in one[:2]),
                          MPPIState(*(v[0] for v in one.state)),
                          *(v[0] for v in one[3:]))
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
    leading B axis; ``eps`` is the injected noise, or None.
    """
    if (seeds is None) == (eps is None):
        raise ValueError("provide exactly one of seeds= or eps=")
    cfg.validate()
    _, wp_idx, path_end, window = cuda_step.step_head(
        cfg, ref_path, observed_x[:, 0:2], observed_x[:, 2:4], state.wp_idx)
    u_seq, s, eps = _solve_kernels(arm, cfg, observed_x, state.u_prev,
                                   window, seeds, eps, step, False)
    next_state = MPPIState(u_prev=shift_warm_start(u_seq), wp_idx=wp_idx)
    return SolveResult(u0=next_state.u_prev[:, 0], u_seq=u_seq,
                       state=next_state, path_end=path_end, costs=s,
                       weights=mppi_weights(s, cfg.lam), eps=eps)


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
    ``want_eps=True``, and this raises ``ValueError`` then."""
    if eps is None:
        raise ValueError(
            "viz_rollouts needs the solve's noise tensor, but SolveResult"
            ".eps is None: re-run solve(..., want_eps=True) (a seeded cuda "
            "solve does not write its noise out by default)")
    k_idx = torch.arange(cfg.num_samples, device=eps.device)
    exploit = (k_idx < (1.0 - cfg.exploration) * cfg.num_samples)[:, None,
                                                                   None]
    v = torch.where(exploit, u_prev[None] + eps, eps)
    return VizResult(
        optimal_traj=rollout_trajectory(arm, cfg, observed_x, u_seq),
        sampled_trajs=rollout_trajectory(arm, cfg, observed_x, v),
        sorted_idx=torch.argsort(costs, stable=True))
