"""Closed-loop metrics and observability.

Solver-health metrics of one solve (:func:`solve_metrics`), closed-loop
tracking errors (:func:`tracking_errors`, NumPy), bench.py's gate statistic
(:func:`onpath_mean_mm`, NumPy), a finiteness check
(:func:`nan_guard`) and a JSON-lines logger with a step cadence
(:class:`MetricsLogger`): the counterparts of
``mppi_robotarm_tpu/utils/metrics.py``.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, TextIO

import numpy as np
import torch

from ..ops.weights import effective_sample_size, weight_entropy

ONPATH_FIRST = 1500          # bench.py's gate window, live steps


def solve_metrics(costs: torch.Tensor, weights: torch.Tensor) -> dict:
    """Scalar health metrics of one solve (cost stats, ESS, entropy)."""
    costs = torch.as_tensor(costs)
    weights = torch.as_tensor(weights)
    return {
        "cost_min": float(torch.amin(costs)),
        "cost_mean": float(torch.mean(costs)),
        "cost_max": float(torch.amax(costs)),
        "ess": float(effective_sample_size(weights)),
        "weight_entropy": float(weight_entropy(weights)),
    }


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


def onpath_mean_mm(ee, done, path_xy, first: int = ONPATH_FIRST) -> float:
    """bench.py's gate statistic (bench.py:143-150): the mean distance, in
    mm, of the EE to the nearest point of ``path_xy`` (N, 2) over the first
    ``first`` live steps of ``ee`` (steps, 2), those whose ``done`` is
    false; NaN when no step is live.  NumPy in the arrays' own dtype, the
    search in chunks of 256 steps, as bench.py does it."""
    ee = np.asarray(ee)[~np.asarray(done, dtype=bool)][:first]
    path_xy = np.asarray(path_xy)
    if not len(ee):
        return float("nan")
    d = [np.linalg.norm(ee[i:i + 256, None, :] - path_xy[None], axis=-1)
         .min(axis=1) for i in range(0, len(ee), 256)]
    return float(np.concatenate(d).mean() * 1e3)


def nan_guard(*arrays) -> bool:
    """True when every array (tensor or NumPy) is finite."""
    return all(bool(torch.isfinite(torch.as_tensor(a)).all()) for a in arrays)


class MetricsLogger:
    """JSON-lines metrics sink with a step cadence (host side)."""

    def __init__(self, stream: Optional[TextIO] = None, every: int = 1):
        self.stream = stream or sys.stderr
        self.every = max(1, every)

    def log(self, step: int, **metrics) -> None:
        if step % self.every:
            return
        self.stream.write(json.dumps({"step": step, **metrics}) + "\n")

    def log_record(self, rec, stride: int = 100) -> None:
        """Dump a SimRecord's solver-health series at ``stride`` cadence."""
        n = rec.cost_min.shape[0]
        for i in range(0, n, stride):
            self.log(i, cost_min=float(rec.cost_min[i]),
                     cost_mean=float(rec.cost_mean[i]),
                     ess=float(rec.ess[i]),
                     weight_entropy=float(rec.weight_entropy[i]),
                     wp_idx=int(rec.wp_idx[i]))
