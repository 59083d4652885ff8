"""2-link planar arm model as batched PyTorch functions.

The counterpart of ``mppi_robotarm_tpu/models/arm.py``: every function takes
tensors of any common shape (or Python floats), never builds 2x2 matrices,
and inverts the inertia matrix analytically.  The expressions keep the JAX
version's operation order, so float64 results agree to rounding.

Quirks kept: Q1 (the ``+ l1``/``+ l2`` inertia terms) and the semi-implicit
Euler order (``dq += ddq·dt``, then ``q += dq_new·dt``).  The reference's
legacy control law (computed torque with an outer PD loop) is here too:
``sim/pathgen.py`` regenerates the reference path with it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import ArmParams


def mass_matrix(q2, p: ArmParams):
    """Elements (M11, M12, M21, M22) of the inertia matrix, with quirk Q1."""
    c2 = torch.cos(q2)
    m11 = (
        p.m1 * p.lc1 ** 2
        + p.l1
        + p.m2 * (p.l1 ** 2 + p.lc2 ** 2 + 2.0 * p.l1 * p.lc2 * c2)
        + p.l2
    )
    m12 = p.m2 * p.l1 * p.lc2 * c2 + p.m2 * p.lc2 ** 2 + p.l2
    m22 = p.m2 * p.lc2 ** 2 + p.l2
    return m11, m12, m12, m22


def gravity_vector(q1, q2, p: ArmParams):
    """(G1, G2): gravity torques."""
    c1 = torch.cos(q1)
    c12 = torch.cos(q1 + q2)
    g1 = p.m1 * p.lc1 * p.g * c1 + p.m2 * p.g * (p.lc2 * c12 + p.l1 * c1)
    g2 = p.m2 * p.lc2 * p.g * c12
    return g1, g2


def arm_ddq(q1, q2, dq1, dq2, u1, u2, p: ArmParams):
    """Joint accelerations ``ddq = M(q)^-1 (u - C(q,dq)·dq - G(q))``."""
    m11, m12, m21, m22 = mass_matrix(q2, p)
    g1, g2 = gravity_vector(q1, q2, p)
    h = p.m2 * p.l1 * p.lc2 * torch.sin(q2)
    cdq1 = -h * dq2 * dq1 + (-h * dq1 - h * dq2) * dq2
    cdq2 = h * dq1 * dq1
    r1 = u1 - cdq1 - g1
    r2 = u2 - cdq2 - g2
    det = m11 * m22 - m12 * m21
    inv_det = 1.0 / det
    ddq1 = (m22 * r1 - m12 * r2) * inv_det
    ddq2 = (-m21 * r1 + m11 * r2) * inv_det
    return ddq1, ddq2


def arm_step(q1, q2, dq1, dq2, u1, u2, dt, p: ArmParams):
    """One semi-implicit Euler step: dq += ddq·dt, then q += dq_new·dt.

    The caller picks dt: ``cfg.delta_t`` in the controller model, ``sim.dt``
    in the plant (quirk Q2).
    """
    ddq1, ddq2 = arm_ddq(q1, q2, dq1, dq2, u1, u2, p)
    dq1n = dq1 + ddq1 * dt
    dq2n = dq2 + ddq2 * dt
    q1n = q1 + dq1n * dt
    q2n = q2 + dq2n * dt
    return q1n, q2n, dq1n, dq2n


def arm_step_fblin(q1, q2, dq1, dq2, v1, v2, dt, p: ArmParams):
    """The reference's ``_F1`` variant (control.py:265-295, never called):
    one semi-implicit Euler step whose input v is a commanded acceleration,
    pre-compensated by feedback linearization with gravity zeroed.

    ``u = M·v + C·dq`` then ``ddq = M⁻¹(u − C·dq)`` (g = 0): the two
    cancel analytically, so ddq is v up to rounding, but the step goes
    through the real M/C arithmetic, as the reference does, rather than
    taking ddq = v.
    """
    p0 = dataclasses.replace(p, g=0.0)
    u1, u2 = feedback_linearization(q1, q2, dq1, dq2, v1, v2, p0)
    ddq1, ddq2 = arm_ddq(q1, q2, dq1, dq2, u1, u2, p0)
    dq1n = dq1 + ddq1 * dt
    dq2n = dq2 + ddq2 * dt
    q1n = q1 + dq1n * dt
    q2n = q2 + dq2n * dt
    return q1n, q2n, dq1n, dq2n


def fk_ee(q1, q2, l1, l2):
    """End-effector position (x2, y2)."""
    x = l1 * torch.cos(q1) + l2 * torch.cos(q1 + q2)
    y = l1 * torch.sin(q1) + l2 * torch.sin(q1 + q2)
    return x, y


def fk_full(q1, q2, p: ArmParams):
    """Elbow and end-effector positions (x1, y1, x2, y2)."""
    x1 = p.l1 * torch.cos(q1)
    y1 = p.l1 * torch.sin(q1)
    x2 = x1 + p.l2 * torch.cos(q1 + q2)
    y2 = y1 + p.l2 * torch.sin(q1 + q2)
    return x1, y1, x2, y2


def ik_circle(theta: torch.Tensor, l1: float = 1.0, l2: float = 1.0,
              closure_overrides: bool = True):
    """Closed-form IK for the reference circle path (utils.py:41-62).

    XE = 0.8 + 0.6·cosθ, YE = 0.8 + 0.6·sinθ, with the reference's two
    piecewise overrides near θ≈2π as masks, then a 2-link arctan IK.
    Returns (r, XE, YE) with r = [x1d, x2d - x1d] of shape (..., 2).
    ``closure_overrides=False`` evaluates the pure circle (multi-revolution
    paths).
    """
    xe = 0.8 + 0.6 * torch.cos(theta)
    ye = 0.8 + 0.6 * torch.sin(theta)
    if closure_overrides:
        two_pi = 2.0 * math.pi
        near_close = (theta >= two_pi - 0.2) & (theta <= two_pi + 0.2)
        past = theta > two_pi + 0.2
        xe = torch.where(near_close, 1.4, xe)
        ye = torch.where(near_close, 0.8, ye)
        xe = torch.where(past, 2.0, xe)
        ye = torch.where(past, 0.0, ye)

    term = torch.sqrt(
        -(xe ** 4)
        - 2.0 * xe ** 2 * ye ** 2
        + 2.0 * xe ** 2 * l1 ** 2
        + 2.0 * xe ** 2 * l2 ** 2
        - ye ** 4
        + 2.0 * ye ** 2 * l1 ** 2
        + 2.0 * ye ** 2 * l2 ** 2
        - l1 ** 4
        + 2.0 * l1 ** 2 * l2 ** 2
        - l2 ** 4
    )
    denom = xe ** 2 + 2.0 * xe * l1 + ye ** 2 + l1 ** 2 - l2 ** 2
    x1d = 2.0 * torch.arctan((2.0 * ye * l1 + term) / denom)
    x2d = 2.0 * torch.arctan((2.0 * ye * l1 - term) / denom)
    r = torch.stack([x1d, x2d - x1d], dim=-1)
    return r, xe, ye


def feedback_linearization(q1, q2, dq1, dq2, v1, v2, p: ArmParams):
    """Computed-torque law ``u = M·v + C·dq + G`` (utils.py:65-84), the
    reference's legacy control path."""
    m11, m12, m21, m22 = mass_matrix(q2, p)
    g1, g2 = gravity_vector(q1, q2, p)
    h = p.m2 * p.l1 * p.lc2 * torch.sin(q2)
    cdq1 = -h * dq2 * dq1 + (-h * dq1 - h * dq2) * dq2
    cdq2 = h * dq1 * dq1
    u1 = m11 * v1 + m12 * v2 + cdq1 + g1
    u2 = m21 * v1 + m22 * v2 + cdq2 + g2
    return u1, u2


def pd_outer_loop(q, dq, r, dr, ddr, kp: float = 100.0, kd: float = 20.0):
    """Outer-loop PD law ``v = ddr - KD·(dq-dr) - KP·(q-r)`` (utils.py:87-93)."""
    return ddr - kd * (dq - dr) - kp * (q - r)
