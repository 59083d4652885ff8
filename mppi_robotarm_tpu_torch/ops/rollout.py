"""Batched K×T MPPI rollout and cost, eager PyTorch.

A Python loop over the horizon whose body is batched over K, and over B
scenarios when given them, the counterpart of
``mppi_robotarm_tpu/ops/rollout.py`` (which the JAX package vmaps over
scenarios).  Semantics kept:
  * the exploration split (Q9): samples k < (1-exploration)·K get u+ε, the
    rest pure ε;
  * stage cost on the post-step state plus γ·uᵀΣ⁻¹v per step;
  * the frozen-window waypoint lookup (Q5);
  * terminal cost on the final state; ×10000 and ×100 scales (Q7).

The cost weights, Σ⁻¹ and the exploration mask are made once per
configuration, dtype and device (:func:`cost_constants`,
:func:`exploit_mask`), so a rollout copies nothing from the host and a
CUDA graph can capture it.  :func:`rollout_trajectory` re-rolls given
controls for visualisation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..config import ArmParams, MPPIConfig
from ..models.arm import arm_step, fk_ee
from .noise import sigma_inverse
from .waypoint import nearest_in_window


class CostConstants(NamedTuple):
    """A configuration's cost constants as tensors of one dtype and device."""

    stage_w: torch.Tensor      # (4,)
    term_w: torch.Tensor       # (4,)
    sigma_inv: torch.Tensor    # (2, 2)


@functools.lru_cache(maxsize=32)
def cost_constants(cfg: MPPIConfig, dtype: torch.dtype,
                   device: torch.device) -> CostConstants:
    """The stage and terminal weights and Σ⁻¹ of ``cfg``, made once per
    (cfg, dtype, device).  Callers never modify them.  On the card the
    copies finish before the first use, which may be on another stream."""
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    out = CostConstants(as_t(cfg.stage_cost_weight),
                        as_t(cfg.terminal_cost_weight),
                        as_t(sigma_inverse(cfg.sigma)))
    if out.stage_w.is_cuda:
        torch.cuda.synchronize(device)
    return out


@functools.lru_cache(maxsize=32)
def exploit_mask(cfg: MPPIConfig, k_local: int, k_offset: int,
                 device: torch.device) -> torch.Tensor:
    """(k_local, 1) bool: global sample ``k_offset + k`` follows u + ε
    (k < (1-exploration)·K, Q9), made once per its arguments."""
    k_global = k_offset + torch.arange(k_local, device=device)
    out = (k_global < (1.0 - cfg.exploration) * cfg.num_samples)[:, None]
    if out.is_cuda:
        torch.cuda.synchronize(device)
    return out


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
    x0: torch.Tensor,          # (..., 4) observed state [q1, q2, dq1, dq2]
    u: torch.Tensor,           # (..., T, 2) nominal control sequence
    eps: torch.Tensor,         # (..., K_local, T, 2) exploration noise
    window: torch.Tensor,      # (..., W, 4) frozen waypoint window
    valid: torch.Tensor,       # (..., W) window validity mask
    sigma_inv=None,            # (2, 2); None: cost_constants' copy
    k_offset: int = 0,         # global index of this shard's first sample
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total cost S of K noisy rollouts, of one scenario or of B.

    One scenario has no leading axis; B scenarios lead every argument
    with B, and each scenario's samples are held against its own window,
    with the same elementwise arithmetic, so each gets the bits of its
    rollout alone.  Returns (S (..., K), x_final (..., K, 4)).
    ``k_offset`` keeps the exploration split, which depends on the global
    sample index, right when the K axis is split across shards.
    """
    kloc = eps.shape[-3]
    dtype, device = eps.dtype, eps.device
    consts = cost_constants(cfg, dtype, device)
    if sigma_inv is None:
        sigma_inv = consts.sigma_inv
    sigma_inv = torch.as_tensor(sigma_inv, dtype=dtype, device=device)
    u = u.to(dtype)
    exploit = exploit_mask(cfg, kloc, k_offset, device)

    x0 = x0.to(dtype)
    lanes = eps.shape[:-2]                      # (..., K)
    q1, q2, dq1, dq2 = (x0[..., i, None].expand(lanes) for i in range(4))
    # Σ⁻¹u of every step, elementwise (the γ term, control.py:106)
    su1 = sigma_inv[0, 0] * u[..., 0] + sigma_inv[0, 1] * u[..., 1]
    su2 = sigma_inv[1, 0] * u[..., 0] + sigma_inv[1, 1] * u[..., 1]
    s = torch.zeros(lanes, dtype=dtype, device=device)
    for t in range(u.shape[-2]):
        eps_t = eps[..., t, :]
        v_t = torch.where(exploit, u[..., t, None, :] + eps_t, eps_t)
        v1, v2 = v_t[..., 0], v_t[..., 1]
        if cfg.u_clamp is not None:            # reference `_g` clamp (Q11)
            v1 = torch.clamp(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = torch.clamp(v2, -cfg.u_clamp, cfg.u_clamp)
        q1, q2, dq1, dq2 = arm_step(q1, q2, dq1, dq2, v1, v2, cfg.delta_t, arm)
        c = _stage_cost(q1, q2, dq1, dq2, window, valid, consts.stage_w, cfg)
        s = s + c + cfg.gamma * (v1 * su1[..., t, None]
                                 + v2 * su2[..., t, None])
    s = s + _stage_cost(q1, q2, dq1, dq2, window, valid, consts.term_w, cfg)
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
