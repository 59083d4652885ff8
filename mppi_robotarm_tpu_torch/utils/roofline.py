"""The least time an H100 could take for a kernel's work.

A bound is the larger of two times: the operations the work needs over the
card's peak rate for float32 outside the tensor cores, and the bytes it
must move (each input read once, each output written once) over the HBM3
rate.  Operations are counted by hand from the plain per-sample code
(``ops/cuda_rollout.py``): each float add, mul, div, compare, select, sin,
cos, log, sqrt, exp and each of Philox's 20 integer multiplies as one, as
PEAK_OPS counts an FMA as two.  ``chip_smoke.py`` and
``tools/extreme_shapes.py`` take their bounds from here.
"""

from __future__ import annotations

from ..config import MPPIConfig

PEAK_OPS = 67e12        # float32 FLOP/s outside the tensor cores, H100 SXM
UNFUSED_OPS = 33.5e12   # unfused float32 op/s: 132 SMs x 128 lanes x 1.98 GHz
PEAK_BYTES = 3.35e12    # HBM3 bytes/s, H100 SXM


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops / PEAK_OPS and nbytes /
    PEAK_BYTES, in ms, and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rollout_ops(samples, T, W, stats):
    """Operations of ``samples`` Philox-noise rollouts over T steps against
    a W-row window: per sample-step 101 + 8W for the rollout and cost, 36
    for the noise and 4 for Σe·ε; per sample 8W + 35 for the initial trig,
    the terminal cost and the softmax, and with ``stats`` the fused loops'
    7 for cost_mean, ESS and entropy (PERF.md section 6)."""
    return samples * (T * (141 + 8 * W) + 8 * W + 35 + (7 if stats else 0))


def solve_ops(cfg: MPPIConfig, n_tiles: int) -> int:
    """Operations of one scenario's solve: the rollouts, the tile
    softmaxes' combine of ``n_tiles`` partials, and the median (at most
    fw² compare pairs an output: the count stops at the median's rank)."""
    T2 = 2 * cfg.horizon
    return (rollout_ops(cfg.num_samples, cfg.horizon, cfg.search_idx_len,
                        False)
            + n_tiles * (6 + 2 * T2) + T2 * (3 + 2 * cfg.filter_window ** 2))


def solve_bound(cfg: MPPIConfig, n_tiles: int):
    """:func:`bound` of one scenario's solve: :func:`solve_ops`, and its
    inputs and outputs (x0, u, the window, S, u_new, m and η in float32,
    seed and step in int64); the tile partials never need to leave the
    chip."""
    T2 = 2 * cfg.horizon
    nbytes = (4 + T2 + 4 * cfg.search_idx_len + cfg.num_samples + T2
              + 2) * 4 + 2 * 8
    return bound(solve_ops(cfg, n_tiles), nbytes)
