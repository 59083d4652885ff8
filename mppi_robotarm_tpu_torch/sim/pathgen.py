"""Reference-path generation through the legacy control pipeline.

The counterpart of ``mppi_robotarm_tpu/sim/pathgen.py``.  The reference's
data files (xydq_circle.txt, 6 columns [x, y, dq1, dq2, u1, u2]) came from
its legacy computed-torque pipeline: IK circle targets (utils.py:41-62) →
outer-loop PD (utils.py:87-93) → feedback-linearization torque
(utils.py:65-84) → plant integration.  :func:`generate_circle_path`
re-creates that closed loop, so the port can synthesise its own reference
paths in the on-disk format, and :func:`save_path_file` writes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..config import ArmParams
from ..device import resolve_device
from ..models.arm import (
    arm_ddq,
    feedback_linearization,
    fk_ee,
    ik_circle,
    pd_outer_loop,
)


def _ik_r(theta):
    return ik_circle(theta)[0]


def generate_circle_path(
    arm: ArmParams,
    num_steps: int = 2000,
    dt: float = 0.003,
    theta_rate: float = 2.0 * math.pi / 6.0,   # rad/s around the circle
    kp: float = 100.0,
    kd: float = 20.0,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Closed-loop legacy tracking run → (num_steps, 6) [x, y, dq1, dq2,
    u1, u2] in ``dtype`` (float32 by default, as the JAX package) on
    ``device`` (default ``cuda``).

    The plant starts at the IK solution of θ=0, the (1.4, 0.8) circle start
    (the reference's initial joint state, run.py:14), and tracks the IK
    joint targets with the PD + computed-torque law.  The targets' rates
    dr, ddr are ``torch.func.jacfwd`` of the IK scaled by the constant θ
    rate.  They depend on the step alone, so all of them come from one
    batched call (``vmap`` over θ) before the sequential loop, which then
    runs the PD law, the torque and the plant step.
    """
    device = resolve_device(device)
    k = torch.arange(num_steps, device=device).to(dtype)
    theta = theta_rate * dt * k
    r = vmap(_ik_r)(theta)
    # forward mode promotes a tangent times a Python float to float64, so
    # the rates come back cast to the path's dtype
    dr = vmap(jacfwd(_ik_r))(theta).to(dtype) * theta_rate
    ddr = vmap(jacfwd(jacfwd(_ik_r)))(theta).to(dtype) * theta_rate ** 2

    q = _ik_r(torch.zeros((), dtype=dtype, device=device))
    dq = torch.zeros(2, dtype=dtype, device=device)
    rows = []
    for i in range(num_steps):
        v = pd_outer_loop(q, dq, r[i], dr[i], ddr[i], kp=kp, kd=kd)
        u1, u2 = feedback_linearization(q[0], q[1], dq[0], dq[1], v[0], v[1],
                                        arm)
        ddq1, ddq2 = arm_ddq(q[0], q[1], dq[0], dq[1], u1, u2, arm)
        dq = dq + dt * torch.stack([ddq1, ddq2])
        q = q + dt * dq
        x, y = fk_ee(q[0], q[1], arm.l1, arm.l2)
        rows.append(torch.stack([x, y, dq[0], dq[1], u1, u2]))
    return torch.stack(rows)


def save_path_file(path: str, rows) -> None:
    """Write rows in the reference's whitespace text format (``%.18e``,
    ``np.loadtxt``-able)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    np.savetxt(path, np.asarray(rows), fmt="%.18e")
