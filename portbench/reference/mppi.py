"""One MPPI solve and one closed-loop step of B scenarios, in any dtype.

Frozen copy of the port's plain versions at commit
d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7:

* the waypoint advance: ``mppi_robotarm_tpu_torch/ops/waypoint.py``
  (``slice_window``, ``nearest_in_window``, ``update_waypoint_index``);
* the rollouts and their cost: ``ops/cuda_rollout.py``
  (``rollout_cost_trig``, ``tracking_cost``), with the exact trig of each
  state in place of the kernels' trig carry, which is the same function;
* the softmax and its statistics: ``ops/cuda_sim.py::_reference_one``;
* the reflected median: ``ops/filters.py::median_filter_reflect``;
* the update, the warm-start shift, the freeze, the plant and the record
  row: ``ops/cuda_sim.py::_reference_one``, ``ops/cuda_step.py::
  step_tail_plain`` and ``plant_step``.

``P`` is the configuration file's dict: ``P["arm"]``, ``P["mppi"]``,
``P["sim"]`` with the port's ``ArmParams``, ``MPPIConfig`` and
``SimConfig`` field names.  Every function takes and returns tensors with
a leading scenario axis B.
"""

from __future__ import annotations

import numpy as np
import torch

from . import arm as arm_model
from . import philox


def window_rows(ref: torch.Tensor, start: torch.Tensor, W: int):
    """Rows ``start .. start + W - 1`` of the path (clamped to its last
    row), (B, W, 4), and which of them exist, (B, W)."""
    n = ref.shape[0]
    idx = start[:, None] + torch.arange(W, device=ref.device)
    return ref[torch.clamp(idx, max=n - 1)], idx < n


def advance(ref, wp, q1, q2, mp: dict):
    """The once-a-solve waypoint advance: the end effector's nearest row
    of the window at ``wp``, ties to the first.  Returns the new index
    (B,) and the window's metric (dx² + dy²)·dist_scale (B, W), ∞ past
    the path end."""
    x, y = arm_model.fk(q1, q2, mp["l1"], mp["l2"])
    win, valid = window_rows(ref, wp, mp["search_idx_len"])
    dx = x[:, None] - win[..., 0]
    dy = y[:, None] - win[..., 1]
    d = torch.where(valid, (dx * dx + dy * dy) * mp["dist_scale"], torch.inf)
    return wp + torch.argmin(d, dim=1), d


def tracking_cost(x, y, dq1, dq2, win, weights, mp: dict):
    """Cost of (B, K) states against their scenario's window (B, W, 4):
    the nearest row by (dx² + dy²)·dist_scale, first-win ties, then
    (w0·Δx² + w1·Δy² + w2·Δdq1² + w3·Δdq2²)·cost_scale."""
    w = win[:, None]                                 # (B, 1, W, 4)
    dx = x[..., None] - w[..., 0]
    dy = y[..., None] - w[..., 1]
    j = torch.argmin((dx * dx + dy * dy) * mp["dist_scale"], dim=-1)
    b = torch.take_along_dim(w, j[..., None, None], dim=-2)[..., 0, :]
    ex, ey = x - b[..., 0], y - b[..., 1]
    e1, e2 = dq1 - b[..., 2], dq2 - b[..., 3]
    w0, w1, w2, w3 = weights
    return (w0 * ex * ex + w1 * ey * ey + w2 * e1 * e1
            + w3 * e2 * e2) * mp["cost_scale"]


def rollout_costs(arm: dict, mp: dict, x0, u, eps, win):
    """Total cost S (B, K) of K noisy rollouts a scenario over T steps of
    the controller model (dt = delta_t): x0 (B, 4), u (B, T, 2), eps (B,
    K, T, 2), win (B, W, 4).  Exploiting samples roll u + ε, the others ε
    alone; each step adds the stage cost of the new state and
    γ·vᵀΣ⁻¹u; the last state adds the terminal cost."""
    K = eps.shape[1]
    exploit = (torch.arange(K, device=eps.device)
               < (1.0 - mp["exploration"]) * K)[None, :]
    si = np.linalg.inv(np.asarray(mp["sigma"], dtype=np.float64))
    gamma = mp["lam"] * (1.0 - mp["alpha"])
    r1, r2, rd1, rd2 = (x0[:, i, None].expand(-1, K) for i in range(4))
    s = torch.zeros(eps.shape[:2], dtype=eps.dtype, device=eps.device)
    for t in range(u.shape[1]):
        u1, u2 = u[:, t, 0, None], u[:, t, 1, None]
        v1 = torch.where(exploit, u1 + eps[..., t, 0], eps[..., t, 0])
        v2 = torch.where(exploit, u2 + eps[..., t, 1], eps[..., t, 1])
        if mp["u_clamp"] is not None:
            v1 = torch.clamp(v1, -mp["u_clamp"], mp["u_clamp"])
            v2 = torch.clamp(v2, -mp["u_clamp"], mp["u_clamp"])
        r1, r2, rd1, rd2 = arm_model.step(arm, r1, r2, rd1, rd2, v1, v2,
                                          mp["delta_t"])
        x, y = arm_model.fk(r1, r2, mp["l1"], mp["l2"])
        s = s + tracking_cost(x, y, rd1, rd2, win, mp["stage_cost_weight"],
                              mp)
        su1 = si[0, 0] * u1 + si[0, 1] * u2
        su2 = si[1, 0] * u1 + si[1, 1] * u2
        s = s + gamma * (v1 * su1 + v2 * su2)
    x, y = arm_model.fk(r1, r2, mp["l1"], mp["l2"])
    return s + tracking_cost(x, y, rd1, rd2, win, mp["terminal_cost_weight"],
                             mp)


def median_reflect(x: torch.Tensor, size: int) -> torch.Tensor:
    """scipy.ndimage.median_filter(size, mode='reflect') along axis 1 of
    (B, T, D): output i's window spans offsets -(size//2) .. size - size//2
    - 1, the edge sample repeated, and an even window takes rank
    size//2."""
    if size == 1:
        return x
    t, left = x.shape[1], size // 2
    idx = torch.arange(-left, t - left + size - 1, device=x.device)
    j = torch.remainder(idx, 2 * t)
    j = torch.where(j < t, j, 2 * t - 1 - j)
    xp = x[:, j]
    windows = torch.stack([xp[:, k:k + t] for k in range(size)], dim=0)
    return torch.sort(windows, dim=0).values[left]


def solve(P: dict, ref, q, dq, u_prev, wp, seed, step, dtype,
          wp_new=None, eps=None) -> dict:
    """One solve of B scenarios in ``dtype``: q, dq (B, 2), u_prev (B, T,
    2), wp, seed, step (B,) int64; ``ref`` the (N, 4) path.  The noise is
    the Philox stream keyed (seed, step), or ``eps`` (B, K, T, 2) in any
    float dtype where the caller drew it (cast to ``dtype``; seed and step
    are then not read).  Returns the new index ``wp`` and the window
    metric ``dist`` it was picked by, ``path_end``, the costs, the weights
    and their statistics, Σwε's median update ``u_new``, its shift
    ``u_next`` and the control ``u0`` = u_next[:, 0].  With ``wp_new`` the
    solve goes on from that index instead of its own pick (the judge hands
    it the program's, which ``dist`` judges)."""
    arm, mp = P["arm"], P["mppi"]
    K, T, lam = mp["num_samples"], mp["horizon"], mp["lam"]
    ref, q, dq, u_prev = (v.to(dtype) for v in (ref, q, dq, u_prev))
    wn, dist = advance(ref, wp, q[:, 0], q[:, 1], mp)
    if wp_new is not None:
        wn = wp_new
    win, _ = window_rows(ref, wn, mp["search_idx_len"])
    eps = (philox.epsilon(seed, step, K, T, mp["sigma"], dtype)
           if eps is None else eps.to(dtype))
    s = rollout_costs(arm, mp, torch.cat([q, dq], dim=1), u_prev, eps, win)
    m = torch.amin(s, dim=1, keepdim=True)
    e = torch.exp(-(s - m) / lam)
    eta = torch.sum(e, dim=1, keepdim=True)
    w = e / eta
    w_eps = torch.sum(w[..., None, None] * eps, dim=1)
    u_new = u_prev + median_reflect(w_eps, mp["filter_window"])
    u_next = torch.cat([u_new[:, 1:], u_new[:, -1:]], dim=1)
    return dict(
        wp=wn, dist=dist, path_end=wn >= ref.shape[0] - 1, costs=s,
        weights=w, cost_min=m[:, 0], cost_mean=torch.mean(s, dim=1),
        ess=1.0 / torch.sum(w * w, dim=1),
        entropy=-torch.sum(torch.where(w > 0, w * torch.log(w), 0.0), dim=1),
        u_new=u_new, u_next=u_next, u0=u_next[:, 0])


def loop_step(P: dict, ref, st: dict, dtype, wp_new=None) -> dict:
    """One closed-loop step of B scenarios from state ``st`` (q, dq,
    u_prev, wp, done, and seed and step or the injected ``eps``): the
    solve, the freeze at the path end, the shifted controls, the plant at
    the plant's dt with the constant disturbance, and the step's record
    row: ``q``, ``dq``, ``u`` (0 where frozen), ``wp``, ``done`` and the
    statistics (0 where frozen), with ``u_next`` the controls carried to
    the next step and ``dist`` the waypoint metric of the solve
    (:func:`solve`, which takes ``wp_new``)."""
    sim = P["sim"]
    r = solve(P, ref, st["q"], st["dq"], st["u_prev"], st["wp"],
              st.get("seed"), st.get("step"), dtype, wp_new, st.get("eps"))
    frz = st["done"] | r["path_end"]
    col = lambda v: frz.view(-1, *(1,) * (v.dim() - 1))
    keep = lambda new, old: torch.where(col(new), old, new)
    zero = lambda v: torch.where(col(v), torch.zeros_like(v), v)
    u_prev = st["u_prev"].to(dtype)
    u_next = keep(r["u_next"], u_prev)
    u0 = u_next[:, 0]
    q, dq = st["q"].to(dtype), st["dq"].to(dtype)
    n = arm_model.step(P["arm"], q[:, 0], q[:, 1], dq[:, 0], dq[:, 1],
                       u0[:, 0] + sim["disturbance"][0],
                       u0[:, 1] + sim["disturbance"][1], sim["dt"])
    return dict(
        q=keep(torch.stack(n[:2], dim=1), q),
        dq=keep(torch.stack(n[2:], dim=1), dq), u=zero(u0),
        wp=torch.where(frz, st["wp"], r["wp"]), done=frz, u_next=u_next,
        dist=r["dist"], **{k: zero(r[k]) for k in
                           ("cost_min", "cost_mean", "ess", "entropy")})
