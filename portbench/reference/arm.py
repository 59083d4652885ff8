"""The 2-link planar arm: kinematics and the semi-implicit Euler step.

Frozen copy of ``mppi_robotarm_tpu_torch/models/arm.py`` (``mass_matrix``,
``gravity_vector``, ``arm_ddq``, ``arm_step``, ``fk_ee``) at commit
d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7, on a plain dict of the arm's
constants.  It keeps the reference's quirk Q1 (the raw link lengths added
to the inertia matrix's diagonal terms) and the step's order: dq += ddq·dt,
then q += dq_new·dt.
"""

from __future__ import annotations

import math

import torch


def ddq(arm: dict, q1, q2, dq1, dq2, u1, u2, cos=torch.cos, sin=torch.sin):
    """Joint accelerations M(q)⁻¹ (u − C(q, dq)·dq − G(q)); ``cos`` and
    ``sin`` of tensors by default, of Python floats with ``math``'s."""
    m1, m2, l1, l2 = arm["m1"], arm["m2"], arm["l1"], arm["l2"]
    lc1, lc2, g = arm["lc1"], arm["lc2"], arm["g"]
    c1, c2, s2, c12 = cos(q1), cos(q2), sin(q2), cos(q1 + q2)
    m11 = (m1 * lc1 ** 2 + l1 + m2 * (l1 ** 2 + lc2 ** 2 + 2.0 * l1 * lc2 * c2)
           + l2)
    m12 = m2 * l1 * lc2 * c2 + m2 * lc2 ** 2 + l2
    m22 = m2 * lc2 ** 2 + l2
    g1 = m1 * lc1 * g * c1 + m2 * g * (lc2 * c12 + l1 * c1)
    g2 = m2 * lc2 * g * c12
    h = m2 * l1 * lc2 * s2
    r1 = u1 - (-h * dq2 * dq1 + (-h * dq1 - h * dq2) * dq2) - g1
    r2 = u2 - h * dq1 * dq1 - g2
    det = m11 * m22 - m12 * m12
    return (m22 * r1 - m12 * r2) / det, (-m12 * r1 + m11 * r2) / det


def step(arm: dict, q1, q2, dq1, dq2, u1, u2, dt, cos=torch.cos,
         sin=torch.sin):
    """One semi-implicit Euler step of length ``dt``."""
    a1, a2 = ddq(arm, q1, q2, dq1, dq2, u1, u2, cos, sin)
    dq1 = dq1 + a1 * dt
    dq2 = dq2 + a2 * dt
    return q1 + dq1 * dt, q2 + dq2 * dt, dq1, dq2


def fk(q1, q2, l1: float, l2: float):
    """End-effector position (x, y)."""
    return (l1 * torch.cos(q1) + l2 * torch.cos(q1 + q2),
            l1 * torch.sin(q1) + l2 * torch.sin(q1 + q2))


def step_host(arm: dict, x, u, dt: float, disturbance=(0.0, 0.0)):
    """:func:`step` of one state on the host in float64 Python scalars,
    the robot's plant: x = (q1, q2, dq1, dq2), u = (u1, u2) plus the
    constant disturbance torque.  Returns the next x as a tuple."""
    q1, q2, dq1, dq2 = (float(v) for v in x)
    return step(arm, q1, q2, dq1, dq2, float(u[0]) + disturbance[0],
                float(u[1]) + disturbance[1], dt, math.cos, math.sin)
