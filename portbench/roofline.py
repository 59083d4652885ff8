"""The least time an H100 could take for the work of live MPPI solves.

Counts from the shapes alone (K, T, W, the filter window, the path's
rows) and the number of live solves: nothing here reads the program, its
tile plan, layout or cluster size, so the same work reads the same bound
whatever kernel does it.  A bound is the larger of the operations over
the card's float32 peak and the bytes over its HBM3 rate; each input byte
is read once and each output byte written once.

The per-sample operation count is a frozen copy of
``mppi_robotarm_tpu_torch/utils/roofline.py::rollout_ops`` at commit
d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7 (each float add, mul, div,
compare, select, sin, cos, log, sqrt, exp and each of Philox's 20 integer
multiplies counted as one, as the peak counts an FMA as two).  The peaks
are NVIDIA's data sheet's for the H100 SXM at its 700 W limit; the run
prints the card's power limit beside every share.
"""

from __future__ import annotations

PEAK_OPS = 67e12        # float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # HBM3 bytes/s
F4, I8 = 4, 8           # float32 and int64 bytes
ROW_BYTES = 12 * F4     # a record row: q, dq, u, index, done, 4 statistics


def rollout_ops(K: int, T: int, W: int, stats: bool) -> int:
    """Operations of K Philox-noise rollouts over T steps against a W-row
    window: per sample-step 101 + 8W for the rollout and cost, 36 for the
    noise and 4 for Σwε; per sample 8W + 35 for the initial trig, the
    terminal cost and the softmax, and with ``stats`` 7 for the cost
    mean, ESS and entropy."""
    return K * (T * (141 + 8 * W) + 8 * W + 35 + (7 if stats else 0))


def solve_ops(mp: dict, stats: bool) -> int:
    """Operations of one solve: the rollouts, the waypoint advance (FK and
    8 a window row) and the median update (at most fw² compare pairs an
    output, 3 more for the update and shift)."""
    T, W, fw = mp["horizon"], mp["search_idx_len"], mp["filter_window"]
    return (rollout_ops(mp["num_samples"], T, W, stats) + 20 + 8 * W
            + 2 * T * (3 + 2 * fw * fw))


def solve_bytes(mp: dict) -> int:
    """Bytes one solve must move alone: the state, u_prev, the window,
    seed and step in; u_new, the costs, the index and flag out."""
    T, W, K = mp["horizon"], mp["search_idx_len"], mp["num_samples"]
    return (4 + 2 * T + 4 * W + 2 * T + K) * F4 + 4 * I8


def bound_s(ops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def loop_bound_s(mp: dict, path_rows: int, solves: int, launches: int,
                 scenarios: int):
    """Bound of whole-loop launches (K1, K3) that made ``solves`` live
    solves in ``launches`` launches of ``scenarios`` scenarios each: the
    solves with their statistics and their record rows; per launch the
    path and each scenario's state and controls in and out."""
    T = mp["horizon"]
    state = 2 * (4 + 2 * T) * F4 + 3 * I8
    return bound_s(solves * solve_ops(mp, True),
                   solves * ROW_BYTES
                   + launches * (path_rows * 4 * F4 + scenarios * state))


def solve_bound_s(mp: dict, solves: int):
    """Bound of ``solves`` per-step solves (K2)."""
    return bound_s(solves * solve_ops(mp, False), solves * solve_bytes(mp))
