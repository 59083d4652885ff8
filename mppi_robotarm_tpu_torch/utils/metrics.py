"""Closed-loop tracking metrics (NumPy)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def tracking_errors(ee: np.ndarray, ref_xy: np.ndarray,
                    full_path: Optional[np.ndarray] = None) -> dict:
    """Closed-loop end-effector tracking error stats.

    ``ee``/``ref_xy``: (steps, 2).  The primary metrics are the reference's
    step-aligned error (vs ref_path[k], run.py:65-68), which penalises lag
    along the path.  When ``full_path`` (N, >=2) is given, the lag-free
    distance to the nearest path point ("on-path" error) is reported too.
    """
    ee = np.asarray(ee)
    ref_xy = np.asarray(ref_xy)
    err = np.linalg.norm(ee - ref_xy, axis=1)
    out = {
        "ee_rms_m": float(np.sqrt(np.mean(err ** 2))),
        "ee_mean_m": float(err.mean()),
        "ee_max_m": float(err.max()),
        "ee_final_m": float(err[-1]),
    }
    if full_path is not None:
        p = np.asarray(full_path)[:, 0:2]
        d = np.linalg.norm(ee[:, None, :] - p[None], axis=2).min(axis=1)
        out["onpath_mean_m"] = float(d.mean())
        out["onpath_max_m"] = float(d.max())
    return out
