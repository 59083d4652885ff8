"""The legacy computed-torque closed loop of ``sim/pathgen.py``: wrapper,
CUDA kernel, plain version.

:func:`pathgen` runs the loop that synthesises a reference path from the
IK targets of every step: the outer-loop PD law, the feedback-linearization
torque, the plant's ddq, a semi-implicit Euler step and the EE position,
one row [x, y, dq1, dq2, u1, u2] a step.  It stands for the ``lax.scan``
the JAX package compiles (``mppi_robotarm_tpu/sim/pathgen.py:55-71``).
CUDA tensors launch ``csrc/pathgen_kernel.cu`` (built by
``ops/_build.py``, bound through ``ctypes``; float32 or float64) once, or
raise; CPU tensors take :func:`pathgen_reference`, the torch loop the
kernel replaced.  Nothing falls back from one to the other.  The kernel
gives the plain version's bits on the card (the same operations in the
same order; see the source).  A launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import ArmParams
from ..models.arm import arm_ddq, feedback_linearization, fk_ee, pd_outer_loop
from .cuda_sim import _check_tensor

# Launches of pathgen_kernel; a run that must show it went through the
# kernel reads this before and after.
LAUNCHES = 0
MAX_STEPS = 2 ** 31 // 6 - 1          # the kernel indexes its rows with int


def pathgen_reference(arm: ArmParams, q0, r, dr, ddr, dt: float,
                      kp: float, kd: float) -> torch.Tensor:
    """Plain version: the closed loop from the joint angles ``q0`` (2,) at
    rest, tracking the targets ``r``, ``dr``, ``ddr`` (N, 2) with the PD +
    computed-torque law, as N dependent steps of torch ops.  Returns (N, 6)
    [x, y, dq1, dq2, u1, u2] in q0's dtype and device."""
    q = q0
    dq = torch.zeros_like(q0)
    rows = []
    for i in range(r.shape[0]):
        v = pd_outer_loop(q, dq, r[i], dr[i], ddr[i], kp=kp, kd=kd)
        u1, u2 = feedback_linearization(q[0], q[1], dq[0], dq[1], v[0], v[1],
                                        arm)
        ddq1, ddq2 = arm_ddq(q[0], q[1], dq[0], dq[1], u1, u2, arm)
        dq = dq + dt * torch.stack([ddq1, ddq2])
        q = q + dt * dq
        x, y = fk_ee(q[0], q[1], arm.l1, arm.l2)
        rows.append(torch.stack([x, y, dq[0], dq[1], u1, u2]))
    return torch.stack(rows)


class _PathgenParams(ctypes.Structure):
    """Mirror of csrc/pathgen_kernel.cu::PathgenParams."""

    _fields_ = [(name, ctypes.c_double) for name in (
        "m11_a", "m11_b", "m11_c", "m2", "l2", "m2l1lc2", "m2lc2sq", "m22",
        "m1lc1g", "m2g", "lc2", "l1", "m2lc2g", "kp", "kd", "dt", "fk_l1",
        "fk_l2")]


def _params(p: ArmParams, dt: float, kp: float, kd: float) -> _PathgenParams:
    """The arm's scalar constants, each the Python expression of
    ``models/arm.py`` that torch takes into a tensor op."""
    return _PathgenParams(
        m11_a=p.m1 * p.lc1 ** 2 + p.l1, m11_b=p.l1 ** 2 + p.lc2 ** 2,
        m11_c=2.0 * p.l1 * p.lc2, m2=p.m2, l2=p.l2,
        m2l1lc2=p.m2 * p.l1 * p.lc2, m2lc2sq=p.m2 * p.lc2 ** 2,
        m22=p.m2 * p.lc2 ** 2 + p.l2, m1lc1g=p.m1 * p.lc1 * p.g,
        m2g=p.m2 * p.g, lc2=p.lc2, l1=p.l1, m2lc2g=p.m2 * p.lc2 * p.g,
        kp=kp, kd=kd, dt=dt, fk_l1=p.l1, fk_l2=p.l2)


def _launch(arm, q0, r, dr, ddr, dt, kp, kd):
    global LAUNCHES
    from ._build import load_library

    dtype, device = q0.dtype, q0.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pathgen_kernel takes float32 or float64, got "
                        f"{dtype}")
    n = r.shape[0] if r.dim() == 2 else -1
    if not 1 <= n <= MAX_STEPS:
        raise ValueError(f"r must be (N, 2) with 1 <= N <= {MAX_STEPS}, got "
                         f"{tuple(r.shape)}")
    _check_tensor("q0", q0, (2,), dtype, device)
    for name, t in (("r", r), ("dr", dr), ("ddr", ddr)):
        _check_tensor(name, t, (n, 2), dtype, device)
    rows = torch.empty((n, 6), dtype=dtype, device=device)
    params = _params(arm, dt, kp, kd)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_pathgen_launch(
            r.data_ptr(), dr.data_ptr(), ddr.data_ptr(), q0.data_ptr(),
            rows.data_ptr(), n, int(dtype == torch.float64),
            ctypes.byref(params),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError("pathgen_kernel launch failed: "
                           + lib.mppi_error_string(err).decode())
    LAUNCHES += 1
    return rows


def pathgen(arm: ArmParams, q0, r, dr, ddr, dt: float, kp: float,
            kd: float) -> torch.Tensor:
    """The closed loop (arguments as :func:`pathgen_reference`): CUDA
    tensors launch ``pathgen_kernel`` once (contiguous, all float32 or all
    float64) or raise; CPU tensors take :func:`pathgen_reference`."""
    if {t.device.type for t in (q0, r, dr, ddr)} == {"cpu"}:
        return pathgen_reference(arm, q0, r, dr, ddr, dt, kp, kd)
    return _launch(arm, q0, r, dr, ddr, dt, kp, kd)
