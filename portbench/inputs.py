"""The benchmark's inputs, made from the configuration and the seed.

The path: a frozen NumPy copy of ``mppi_robotarm_tpu_torch/sim/paths.py::
synth_circle_path`` and ``models/arm.py::ik_circle`` at commit
d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7 (the reference's circle,
utils.py:41-62: XE = 0.8 + 0.6·cosθ, YE = 0.8 + 0.6·sinθ with its two
closure overrides near θ = 2π, a closed-form 2-link IK, joint-velocity
references by finite differences at the plant's dt).  Seeds: every chain,
episode and scenario draws its 31-bit noise seed from ``--seed`` and its
own index, so one ``--seed`` gives the same inputs every time and any
whole number is a valid ``--seed``.
"""

from __future__ import annotations

import numpy as np


def circle_path(num_waypoints: int, dt: float = 0.003) -> np.ndarray:
    """(N, 4) float32 rows [x, y, dq1, dq2] of one revolution."""
    theta = np.linspace(0.0, 2.0 * np.pi, num_waypoints, endpoint=False)
    xe = 0.8 + 0.6 * np.cos(theta)
    ye = 0.8 + 0.6 * np.sin(theta)
    near = (theta >= 2.0 * np.pi - 0.2) & (theta <= 2.0 * np.pi + 0.2)
    xe, ye = np.where(near, 1.4, xe), np.where(near, 0.8, ye)
    l1 = l2 = 1.0
    term = np.sqrt(-xe ** 4 - 2.0 * xe ** 2 * ye ** 2 + 2.0 * xe ** 2 * l1 ** 2
                   + 2.0 * xe ** 2 * l2 ** 2 - ye ** 4
                   + 2.0 * ye ** 2 * l1 ** 2 + 2.0 * ye ** 2 * l2 ** 2
                   - l1 ** 4 + 2.0 * l1 ** 2 * l2 ** 2 - l2 ** 4)
    denom = xe ** 2 + 2.0 * xe * l1 + ye ** 2 + l1 ** 2 - l2 ** 2
    x1d = 2.0 * np.arctan((2.0 * ye * l1 + term) / denom)
    x2d = 2.0 * np.arctan((2.0 * ye * l1 - term) / denom)
    dq = np.gradient(np.stack([x1d, x2d - x1d], axis=1), axis=0) / dt
    return np.ascontiguousarray(
        np.stack([xe, ye, dq[:, 0], dq[:, 1]], axis=1), dtype=np.float32)


def seeds(seed: int, index: int, count: int) -> np.ndarray:
    """``count`` 31-bit noise seeds of chain or episode ``index`` of a run
    with ``--seed`` ``seed`` (int64)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), int(index)])
    return (ss.generate_state(count, dtype=np.uint32)
            & 0x7FFFFFFF).astype(np.int64)


def rng(seed: int, purpose: int) -> np.random.Generator:
    """A generator of the run's ``--seed`` for one purpose (initial
    states, the samples the check compares)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), 1 << 20,
                                  int(purpose)])
