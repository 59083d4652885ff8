"""Batched K×T MPPI rollout and cost, eager PyTorch.

A Python loop over the horizon whose body is batched over K, the
counterpart of ``mppi_robotarm_tpu/ops/rollout.py``.  Semantics kept:
  * the exploration split (Q9): samples k < (1-exploration)·K get u+ε, the
    rest pure ε;
  * stage cost on the post-step state plus γ·uᵀΣ⁻¹v per step;
  * the frozen-window waypoint lookup (Q5);
  * terminal cost on the final state; ×10000 and ×100 scales (Q7).

:func:`rollout_trajectory` re-rolls given controls for visualisation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ArmParams, MPPIConfig
from ..models.arm import arm_step, fk_ee
from .waypoint import nearest_in_window


def _stage_cost(q1, q2, dq1, dq2, window, valid, weights, cfg: MPPIConfig):
    """Weighted tracking cost of a batch of states vs their nearest
    waypoints (reference ``_c`` / ``_phi``, control.py:174-198)."""
    x, y = fk_ee(q1, q2, cfg.l1, cfg.l2)
    _, rx, ry, rdq1, rdq2 = nearest_in_window(x, y, window, valid,
                                              cfg.dist_scale)
    c = (
        weights[0] * (x - rx) ** 2
        + weights[1] * (y - ry) ** 2
        + weights[2] * (dq1 - rdq1) ** 2
        + weights[3] * (dq2 - rdq2) ** 2
    )
    return c * cfg.cost_scale


def rollout_costs(
    arm: ArmParams,
    cfg: MPPIConfig,
    x0: torch.Tensor,          # (4,) observed state [q1, q2, dq1, dq2]
    u: torch.Tensor,           # (T, 2) nominal control sequence
    eps: torch.Tensor,         # (K_local, T, 2) exploration noise
    window: torch.Tensor,      # (W, 4) frozen waypoint window
    valid: torch.Tensor,       # (W,) window validity mask
    sigma_inv: torch.Tensor,   # (2, 2)
    k_offset: int = 0,         # global index of this shard's first sample
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total cost S of K noisy rollouts.

    Returns (S (K,), x_final (K, 4)).  ``k_offset`` keeps the exploration
    split, which depends on the global sample index, right when the K axis
    is split across shards.
    """
    kloc = eps.shape[0]
    dtype, device = eps.dtype, eps.device
    stage_w = torch.as_tensor(cfg.stage_cost_weight, dtype=dtype,
                              device=device)
    term_w = torch.as_tensor(cfg.terminal_cost_weight, dtype=dtype,
                             device=device)
    sigma_inv = torch.as_tensor(sigma_inv, dtype=dtype, device=device)
    u = u.to(dtype)

    k_global = k_offset + torch.arange(kloc, device=device)
    exploit = (k_global < (1.0 - cfg.exploration) * cfg.num_samples)[:, None]

    x0 = x0.to(dtype)
    q1, q2, dq1, dq2 = (x0[i].expand(kloc) for i in range(4))
    s = torch.zeros(kloc, dtype=dtype, device=device)
    for t in range(u.shape[0]):
        u_t, eps_t = u[t], eps[:, t]
        v_t = torch.where(exploit, u_t + eps_t, eps_t)
        v1, v2 = v_t[:, 0], v_t[:, 1]
        if cfg.u_clamp is not None:            # reference `_g` clamp (Q11)
            v1 = torch.clamp(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = torch.clamp(v2, -cfg.u_clamp, cfg.u_clamp)
        q1, q2, dq1, dq2 = arm_step(q1, q2, dq1, dq2, v1, v2, cfg.delta_t, arm)
        c = _stage_cost(q1, q2, dq1, dq2, window, valid, stage_w, cfg)
        su = sigma_inv @ u_t
        s = s + c + cfg.gamma * (v1 * su[0] + v2 * su[1])
    s = s + _stage_cost(q1, q2, dq1, dq2, window, valid, term_w, cfg)
    return s, torch.stack([q1, q2, dq1, dq2], dim=-1)


def rollout_trajectory(
    arm: ArmParams,
    cfg: MPPIConfig,
    x0: torch.Tensor,          # (4,)
    v: torch.Tensor,           # (..., T, 2) control sequences
) -> torch.Tensor:
    """State trajectories under given controls: the visualisation
    re-rollouts.  Keeps the reference's off-by-one (quirk Q4): step t
    applies ``v[..., t-1]``, so the LAST control is applied first
    (control.py:132-134, 142-143).  Returns (..., T, 4)."""
    v = torch.roll(v, 1, dims=-2)
    batch = v.shape[:-2]
    x0 = x0.to(v.dtype)
    q1, q2, dq1, dq2 = (x0[i].expand(batch) for i in range(4))
    traj = []
    for t in range(v.shape[-2]):
        v1, v2 = v[..., t, 0], v[..., t, 1]
        if cfg.u_clamp is not None:
            v1 = torch.clamp(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = torch.clamp(v2, -cfg.u_clamp, cfg.u_clamp)
        q1, q2, dq1, dq2 = arm_step(q1, q2, dq1, dq2, v1, v2, cfg.delta_t, arm)
        traj.append(torch.stack([q1, q2, dq1, dq2], dim=-1))
    return torch.stack(traj, dim=-2)
