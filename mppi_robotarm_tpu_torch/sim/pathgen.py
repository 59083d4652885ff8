"""Reference-path generation through the legacy control pipeline.

The counterpart of ``mppi_robotarm_tpu/sim/pathgen.py``.  The reference's
data files (xydq_circle.txt, 6 columns [x, y, dq1, dq2, u1, u2]) came from
its legacy computed-torque pipeline: IK circle targets (utils.py:41-62) →
outer-loop PD (utils.py:87-93) → feedback-linearization torque
(utils.py:65-84) → plant integration.  :func:`generate_circle_path`
re-creates that closed loop, so the port can synthesise its own reference
paths in the on-disk format, and :func:`save_path_file` writes them.  The
loop itself is ``ops/cuda_pathgen.py``'s: one kernel launch on the card,
its plain version ``pathgen_reference`` on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..config import ArmParams
from ..device import resolve_device
from ..models.arm import ik_circle
from ..ops.cuda_pathgen import pathgen


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
    runs the PD law, the torque and the plant step: on the card one launch
    of ``csrc/pathgen_kernel.cu``, on the CPU its plain version
    (``ops/cuda_pathgen.py``).
    """
    q0, r, dr, ddr = circle_targets(num_steps, dt, theta_rate, dtype,
                                    resolve_device(device))
    return pathgen(arm, q0, r, dr, ddr, dt, kp, kd)


def circle_targets(num_steps: int, dt: float, theta_rate: float, dtype,
                   device):
    """The closed loop's start and targets: (q0 (2,), r, dr, ddr (N, 2))
    in ``dtype`` on ``device``, the IK of θ = 0 and of θ = theta_rate·dt·k
    for each step k, with its rates."""
    k = torch.arange(num_steps, device=device).to(dtype)
    theta = theta_rate * dt * k
    r = vmap(_ik_r)(theta)
    # forward mode promotes a tangent times a Python float to float64, so
    # the rates come back cast to the path's dtype
    dr = vmap(jacfwd(_ik_r))(theta).to(dtype) * theta_rate
    ddr = vmap(jacfwd(jacfwd(_ik_r)))(theta).to(dtype) * theta_rate ** 2
    q0 = _ik_r(torch.zeros((), dtype=dtype, device=device))
    return q0, r.contiguous(), dr, ddr


def save_path_file(path: str, rows) -> None:
    """Write rows in the reference's whitespace text format (``%.18e``,
    ``np.loadtxt``-able)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    np.savetxt(path, np.asarray(rows), fmt="%.18e")
