"""Offline plotting with reference figure parity, on NumPy records.

The counterparts of ``mppi_robotarm_tpu/utils/plotting.py``:
  * :func:`plot_results` — Figure 1 (θ1/θ2 in degrees, EE x and y against
    the reference over time, run.py:120-158) and Figure 2 (controls u1, u2,
    run.py:161-173);
  * :func:`plot_sampled_trajectories` — the per-step sampled-trajectory
    render with rank-based alpha (run.py:73-118);
  * :func:`plot_arm_schematic` and :func:`animate_arm` — the arm pose plot
    and the joint-trajectory animation.

Inputs are arrays (NumPy or tensors, converted to NumPy).  matplotlib is
imported inside the functions, on its Agg backend, and ``plt.show()`` is
never called: figures are for ``savefig``.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def plot_results(rec, ref_path):
    """Reference Figure 1 + Figure 2 from a SimRecord (run.py:120-173).

    The x axis is the raw step index labelled 'Time(s)', as in the
    reference (run.py:71 fills ``t_rec[k] = k``).  The reference curves are
    drawn only over the rows the path has.
    """
    plt = _plt()
    q = _np(rec.q)
    u = _np(rec.u)
    ee = _np(rec.ee)
    n = q.shape[0]
    t = np.arange(1, n + 1)
    ref = _np(ref_path)
    m = min(n, ref.shape[0] - 1)
    rx = ref[1:m + 1, 0]
    ry = ref[1:m + 1, 1]
    tr = t[:m]

    fig1, axes = plt.subplots(2, 2, figsize=(11, 7))
    axes[0, 0].plot(t, 180 / np.pi * q[:, 0], "k", linewidth=1.2)
    axes[0, 0].set_title("Theta 1 Input & Output")
    axes[0, 0].set_xlabel("Time(s)"); axes[0, 0].set_ylabel("Theta (Deg)")
    axes[0, 0].grid(True)
    axes[0, 1].plot(t, 180 / np.pi * q[:, 1], "k", linewidth=1.2)
    axes[0, 1].set_title("Theta 2 Input & Output")
    axes[0, 1].set_xlabel("Time(s)"); axes[0, 1].set_ylabel("Theta (Deg)")
    axes[0, 1].grid(True)
    axes[1, 0].plot(t, ee[:, 0], "k", tr, rx, "--b", linewidth=1.2)
    axes[1, 0].set_title("X(end point) Input & Output")
    axes[1, 0].set_xlabel("Time(s)"); axes[1, 0].set_ylabel("X (m)")
    axes[1, 0].legend(["X output", "X input"]); axes[1, 0].grid(True)
    axes[1, 1].plot(t, ee[:, 1], "k", tr, ry, "--b", linewidth=1.2)
    axes[1, 1].set_title("Y(end point) Input & Output")
    axes[1, 1].set_xlabel("Time(s)"); axes[1, 1].set_ylabel("Y (m)")
    axes[1, 1].legend(["Y output", "Y input"]); axes[1, 1].grid(True)
    fig1.tight_layout()

    fig2, (a1, a2) = plt.subplots(2, 1, figsize=(9, 6))
    a1.plot(t, u[:, 0], "k", linewidth=1.2); a1.set_title("u(1)"); a1.grid(True)
    a2.plot(t, u[:, 1], "k", linewidth=1.2); a2.set_title("u(2)"); a2.grid(True)
    fig2.tight_layout()
    return fig1, fig2


def plot_sampled_trajectories(q, sampled_trajs, optimal_traj, ref_path,
                              sorted_idx=None):
    """The per-step sample render (run.py:73-118): arm links, K sampled EE
    trajectories with rank-based alpha, optimal EE trajectory, ref path."""
    plt = _plt()
    q = _np(q)
    sampled = _np(sampled_trajs)
    opt = _np(optimal_traj)
    ref = _np(ref_path)
    x1, y1 = np.cos(q[0]), np.sin(q[0])
    x2 = x1 + np.cos(q[0] + q[1])
    y2 = y1 + np.sin(q[0] + q[1])

    fig, ax = plt.subplots()
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlim(0, 1.5); ax.set_ylim(0, 1.5)
    ax.set_title("Sampled Trajectories")
    ax.plot([0, x1], [0, y1], "k", linewidth=4)
    ax.plot([x1, x2], [y1, y2], "k", linewidth=4)

    order = (_np(sorted_idx) if sorted_idx is not None
             else np.arange(sampled.shape[0]))
    lo, hi = 0.25, 0.35                       # run.py:77-78
    kk = len(order)
    for rank, k in enumerate(order):
        alpha = (1.0 - (rank + 1) / kk) * (hi - lo) + lo
        sq1, sq2 = sampled[k, :, 0], sampled[k, :, 1]
        ax.plot(np.cos(sq1) + np.cos(sq1 + sq2),
                np.sin(sq1) + np.sin(sq1 + sq2),
                color="gray", linewidth=0.2, alpha=alpha, zorder=4)
    oq1, oq2 = opt[:, 0], opt[:, 1]
    ax.plot(np.cos(oq1) + np.cos(oq1 + oq2), np.sin(oq1) + np.sin(oq1 + oq2),
            color="red", linewidth=1, zorder=4)
    ax.plot(ref[:, 0], ref[:, 1], "--b")
    return fig


def plot_arm_schematic(q=(np.pi / 2, -np.pi / 2)):
    """Static 2-link arm pose plot (Robot_shcematic.py parity)."""
    plt = _plt()
    x1, y1 = np.cos(q[0]), np.sin(q[0])
    x2 = x1 + np.cos(q[0] + q[1])
    y2 = y1 + np.sin(q[0] + q[1])
    fig, ax = plt.subplots()
    ax.plot([0, x1], [0, y1], "k", linewidth=4)
    ax.plot([x1, x2], [y1, y2], "k", linewidth=4)
    ax.plot([0, x1, x2], [0, y1, y2], "o", color="tab:blue", markersize=8)
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlim(-2.2, 2.2); ax.set_ylim(-2.2, 2.2)
    ax.grid(True)
    return fig


def animate_arm(q_seq, interval_ms: int = 20):
    """FuncAnimation of a joint trajectory (visualize.py parity)."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation

    q_seq = _np(q_seq)
    fig, ax = plt.subplots()
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlim(-2.2, 2.2); ax.set_ylim(-2.2, 2.2)
    link1, = ax.plot([], [], "k", linewidth=4)
    link2, = ax.plot([], [], "k", linewidth=4)

    def update(i):
        q1, q2 = q_seq[i]
        x1, y1 = np.cos(q1), np.sin(q1)
        x2, y2 = x1 + np.cos(q1 + q2), y1 + np.sin(q1 + q2)
        link1.set_data([0, x1], [0, y1])
        link2.set_data([x1, x2], [y1, y2])
        return link1, link2

    return FuncAnimation(fig, update, frames=len(q_seq),
                         interval=interval_ms, blit=True)
