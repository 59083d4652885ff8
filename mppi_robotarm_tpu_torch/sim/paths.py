"""Reference-path loading and synthesis.

``load_ref_path`` accepts the reference's 4- and 6-column path files and
returns the (N, 4) [x, y, dq1, dq2] slice the controller consumes.
``synth_circle_path`` re-synthesises the reference circle from the port's
IK, so the port runs without the data files.
"""

from __future__ import annotations

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
