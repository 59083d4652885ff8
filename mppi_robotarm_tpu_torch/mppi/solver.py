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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ArmParams, MPPIConfig
from ..models.arm import fk_ee
from ..ops.filters import median_filter_reflect
from ..ops.noise import sample_epsilon, sigma_cholesky, sigma_inverse
from ..ops.rollout import rollout_costs
from ..ops.waypoint import update_waypoint_index
from ..ops.weights import mppi_weights


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
    eps: torch.Tensor            # (K, T, 2) the noise used


def init_state(cfg: MPPIConfig, dtype=torch.float32,
               device=None) -> MPPIState:
    """Warm start ``u_prev = [(10, -2)] * T`` (control.py:59), index 0."""
    u0 = torch.tensor(cfg.warm_start, dtype=dtype,
                      device=device).repeat(cfg.horizon, 1)
    return MPPIState(u_prev=u0,
                     wp_idx=torch.tensor(0, dtype=torch.int64, device=device))


def shift_warm_start(u_seq: torch.Tensor) -> torch.Tensor:
    """Drop u[0] and duplicate the last row (control.py:148-149)."""
    return torch.cat([u_seq[1:], u_seq[-1:]], dim=0)


def solve(
    arm: ArmParams,
    cfg: MPPIConfig,
    ref_path: torch.Tensor,       # (N, 4) [x, y, dq1, dq2]
    observed_x: torch.Tensor,     # (4,) [q1, q2, dq1, dq2]
    state: MPPIState,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> SolveResult:
    """One MPPI solve (control.py:67-152) in the dtype of ``state.u_prev``.

    Noise is either injected (``eps`` (K, T, 2), the parity seam) or drawn
    from ``generator``; exactly one must be given.
    """
    if (eps is None) == (generator is None):
        raise ValueError("provide exactly one of eps= or generator=")
    cfg.validate()
    dtype = state.u_prev.dtype
    device = state.u_prev.device

    x_obs, y_obs = fk_ee(observed_x[0], observed_x[1], cfg.l1, cfg.l2)
    wp_idx, window, valid = update_waypoint_index(
        ref_path, state.wp_idx, x_obs, y_obs, cfg.search_idx_len,
        cfg.dist_scale)
    path_end = wp_idx >= ref_path.shape[0] - 1

    if eps is None:
        eps = sample_epsilon(generator, cfg.num_samples, cfg.horizon,
                             sigma_cholesky(cfg.sigma), dtype)
    eps = eps.to(dtype)
    sigma_inv = torch.as_tensor(sigma_inverse(cfg.sigma), dtype=dtype,
                                device=device)
    s, _ = rollout_costs(arm, cfg, observed_x, state.u_prev, eps,
                         window.to(dtype), valid, sigma_inv)
    w = mppi_weights(s, cfg.lam)
    # Σₖ wₖεₖ accumulated in sample order, as the reference's NumPy does
    w_eps = torch.sum(w[:, None, None] * eps, dim=0)  # control.py:115-118
    w_eps = median_filter_reflect(w_eps, cfg.filter_window)   # Q10
    u_seq = state.u_prev + w_eps                     # control.py:126 (Q3)

    next_state = MPPIState(u_prev=shift_warm_start(u_seq), wp_idx=wp_idx)
    return SolveResult(u0=next_state.u_prev[0], u_seq=u_seq,
                       state=next_state, path_end=path_end, costs=s,
                       weights=w, eps=eps)
