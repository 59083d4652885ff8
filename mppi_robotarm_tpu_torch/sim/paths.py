"""Reference-path loading and synthesis.

``load_ref_path`` accepts the reference's 4- and 6-column path files and
returns the (N, 4) [x, y, dq1, dq2] slice the controller consumes.
``load_joint_log`` reads a [q1, q2, x, y] trajectory log (the reference's
``trajectory.txt``) and ``ref_path_from_joint_log`` turns it into that
path format.  ``synth_circle_path`` re-synthesises the reference circle
from the port's IK, so the port runs without the data files.
``reference_circle_path`` reads the reference's own circle,
``xydq_circle.txt``, from the copy the checkout keeps in
``tests/data/reference_golden_run.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.arm import ik_circle


def load_ref_path(path: str, dtype=np.float32) -> np.ndarray:
    """Load a 4- or 6-column whitespace path file → (N, 4) [x, y, dq1, dq2]
    (``np.loadtxt(...)[:, 0:4]``, run.py:18-19)."""
    raw = np.loadtxt(path)
    if raw.ndim != 2 or raw.shape[1] not in (4, 6):
        raise ValueError(
            f"expected a (N,4) or (N,6) path file, got shape {raw.shape}"
        )
    return np.ascontiguousarray(raw[:, 0:4], dtype=dtype)


REFERENCE_RUN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "data", "reference_golden_run.npz")


def reference_circle_path() -> np.ndarray:
    """The reference's ``xydq_circle.txt`` as ``np.loadtxt(...)[:, 0:4]``
    reads it, (2000, 4) float64: ``ref_path`` of the golden run's npz at
    :data:`REFERENCE_RUN` (``tools/make_reference_golden.py`` stored the
    file's columns there).  Raises ``FileNotFoundError`` when the npz is
    missing; nothing stands in for it."""
    if not os.path.isfile(REFERENCE_RUN):
        raise FileNotFoundError(f"{REFERENCE_RUN} is missing: it holds the "
                                f"reference's circle path")
    with np.load(REFERENCE_RUN) as run:
        return np.ascontiguousarray(run["ref_path"])


def load_joint_log(path: str, dtype=np.float32) -> np.ndarray:
    """Load a [q1, q2, x, y] trajectory log (trajectory.txt format)."""
    raw = np.loadtxt(path)
    if raw.ndim != 2 or raw.shape[1] != 4:
        raise ValueError(f"expected a (N,4) log file, got shape {raw.shape}")
    return np.ascontiguousarray(raw, dtype=dtype)


def ref_path_from_joint_log(log: np.ndarray, dt: float = 0.003,
                            dtype=np.float32) -> np.ndarray:
    """A [q1, q2, x, y] joint log → the controller's (N, 4) [x, y, dq1, dq2]
    path: joint velocities are central differences of the logged angles at
    the plant timestep, taken in float64 (BASELINE config 1's input)."""
    log = np.asarray(log, dtype=np.float64)
    if log.ndim != 2 or log.shape[1] != 4:
        raise ValueError(f"expected a (N,4) [q1,q2,x,y] log, got {log.shape}")
    dq = np.gradient(log[:, 0:2], axis=0) / dt
    out = np.concatenate([log[:, 2:4], dq], axis=1)
    return np.ascontiguousarray(out, dtype=dtype)


def synth_circle_path(
    num_waypoints: int = 2000,
    revolutions: float = 1.0,
    dt: float = 0.003,
    dtype=np.float32,
) -> np.ndarray:
    """Synthesise an (N, 4) circle reference path from the IK.

    XE/YE from utils.py:45-46, joint-velocity references from the finite
    difference of the IK joint targets.  The IK runs in float64.
    """
    theta = np.linspace(0.0, 2.0 * np.pi * revolutions, num_waypoints,
                        endpoint=False)
    # the θ≈2π closure overrides are a single-revolution quirk; beyond one
    # revolution they would pin the path at the singular (2, 0) pose
    r, xe, ye = ik_circle(torch.as_tensor(theta, dtype=torch.float64),
                          closure_overrides=revolutions <= 1.0)
    r = r.numpy()
    dq = np.gradient(r, axis=0) / dt
    out = np.stack([xe.numpy(), ye.numpy(), dq[:, 0], dq[:, 1]], axis=1)
    return np.ascontiguousarray(out, dtype=dtype)
