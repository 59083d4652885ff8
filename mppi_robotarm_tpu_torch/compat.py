"""Drop-in layer with the reference repo's API, on the PyTorch port.

The counterpart of ``mppi_robotarm_tpu/compat.py``.  A user of the
reference switches by changing imports only::

    # from control import MPPIControllerForPathTracking
    # from utils import Arm_Dynamic, Forward_Kinemetic, ...
    # from sys_params import SYS_PARAMS
    from mppi_robotarm_tpu_torch.compat import (
        MPPIControllerForPathTracking, Arm_Dynamic, Forward_Kinemetic,
        Inverse_Kinemetic, Feedback_linearization, Controller, SYS_PARAMS)

Every public symbol of the reference's ``control.py`` / ``utils.py`` /
``sys_params.py`` keeps its signature, defaults, return structure, NumPy
in and out, and side effects (the mutable ``u_prev`` /
``prev_waypoints_idx`` attributes, the path-end ``IndexError`` of
control.py:76-78).  The K×T rollout sweep runs through the port's solver
(``mppi.solver.solve``): the solve kernel on the GPU with
``backend="cuda"`` (the default), or eager PyTorch with
``backend="eager"``, on ``device`` (None: ``cuda``).

The applied control is the reference's net behaviour (quirk Q3: the
in-place warm-start shift precedes ``return u[0]`` on the aliased array,
control.py:148-152, so the applied control is the SHIFTED first element).
Noise is drawn on the host with ``np.random.multivariate_normal`` from the
global NumPy RNG by default, the reference's sampling path with quirk Q8
(``np.random.seed`` governs it as in the reference); ``rng=`` takes a
``np.random.Generator`` for a stream of its own.

The kinematics helpers (``Arm_Dynamic`` and the rest) compute in float64
on the host by design, not as a fallback from the GPU: each is a
four-number computation called once per step of a host loop, which a
device launch and copy would only slow (the JAX package pins them to its
CPU backend for the same reason, ``mppi_robotarm_tpu/compat.py:65``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .config import ArmParams, MPPIConfig
from .device import resolve_device
from .models import arm as _arm
from .mppi.solver import MPPIState, solve, viz_rollouts

__all__ = [
    "SYS_PARAMS",
    "Arm_Dynamic",
    "Forward_Kinemetic",
    "Inverse_Kinemetic",
    "Feedback_linearization",
    "Controller",
    "MPPIControllerForPathTracking",
]

_PARAMS = ArmParams()


def _host(x) -> torch.Tensor:
    """A float64 CPU tensor of ``x``, flattened."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64).reshape(-1))


def SYS_PARAMS() -> dict:
    """Physical-constant dict, identical to the reference sys_params.py:1-13."""
    p = dataclasses.asdict(_PARAMS)
    return {
        "Ts": p["Ts"], "m1": p["m1"], "m2": p["m2"], "l1": p["l1"],
        "l2": p["l2"], "lc1": p["lc1"], "lc2": p["lc2"], "g": p["g"],
    }


def Arm_Dynamic(q, dq, u):
    """Plant dynamics ``ddq = M⁻¹(u − C·dq − G)`` (utils.py:14-29) of
    length-2 q, dq, u."""
    q, dq, u = _host(q), _host(dq), _host(u)
    dd1, dd2 = _arm.arm_ddq(q[0], q[1], dq[0], dq[1], u[0], u[1], _PARAMS)
    return np.array([float(dd1), float(dd2)])


def Forward_Kinemetic(q):
    """FK of the 2-link arm → (x1, y1, x2, y2) (utils.py:32-38)."""
    q = _host(q)
    return tuple(float(v) for v in _arm.fk_full(q[0], q[1], _PARAMS))


def Inverse_Kinemetic(Theta):
    """Circle-path IK → (r, XE, YE) (utils.py:41-62): ``r = [x1d, x2d −
    x1d]`` joint targets, with the reference's two overrides near θ≈2π."""
    r, xe, ye = _arm.ik_circle(torch.tensor(float(Theta),
                                            dtype=torch.float64))
    return r.numpy(), float(xe), float(ye)


def Feedback_linearization(q, dq, v):
    """Computed-torque law ``u = M·v + C·dq + G`` (utils.py:65-84)."""
    q, dq, v = _host(q), _host(dq), _host(v)
    u1, u2 = _arm.feedback_linearization(q[0], q[1], dq[0], dq[1], v[0],
                                         v[1], _PARAMS)
    return np.array([float(u1), float(u2)])


def Controller(q, dq, r, dr, ddr):
    """Outer-loop PD law ``v = ddr − KD(dq−dr) − KP(q−r)``, KD=20, KP=100
    (utils.py:87-93)."""
    return _arm.pd_outer_loop(_host(q), _host(dq), _host(r), _host(dr),
                              _host(ddr)).numpy()


class MPPIControllerForPathTracking:
    """Reference-signature MPPI controller on the port's solver.

    Constructor signature, defaults, public attributes (``u_prev``,
    ``prev_waypoints_idx``, ``param_gamma``, …) and the
    ``calc_control_input(observed_x) -> (u0, u_seq, optimal_traj,
    sampled_traj_list)`` return structure mirror control.py:21-152.

    Keyword-only extras:

    * ``backend`` — 'cuda' (default: the solve kernel, float32 inside) or
      'eager' (PyTorch);
    * ``device`` — where the solve runs; None means ``cuda``;
    * ``rng`` — a ``np.random.Generator`` for isolated noise; default
      ``None`` draws from the global ``np.random`` like the reference (Q8);
    * ``search_idx_len`` / ``filter_window`` — the reference's hardcoded
      30 (control.py:203) and 10 (control.py:122).
    """

    def __init__(
        self,
        delta_t: float = 0.01,
        ref_path=0,
        horizon_step_T: int = 20,
        number_of_samples_K: int = 500,
        param_exploration: float = 0.0,
        param_lambda: float = 50.0,
        param_alpha: float = 1.0,
        sigma=np.array([[10.0, 10.0], [100.0, 100.0]]),
        stage_cost_weight=np.array([10.0, 10.0, 10.0, 10.0]),
        terminal_cost_weight=np.array([10.0, 10.0, 10.0, 10.0]),
        visualize_optimal_traj=True,
        visualze_sampled_trajs=False,
        *,
        backend: str = "cuda",
        device=None,
        rng: Optional[np.random.Generator] = None,
        search_idx_len: int = 30,
        filter_window: int = 10,
    ) -> None:
        # the reference's Σ validation (control.py:157-159)
        sigma = np.asarray(sigma, dtype=np.float64)
        self.dim_x = 4
        self.dim_u = 2
        if sigma.shape != (self.dim_u, self.dim_u):
            raise ValueError(
                "sigma must be a square matrix with the size of dim_u.")
        if backend not in ("cuda", "eager"):
            raise ValueError(f"unknown backend {backend!r}")

        self.T = int(horizon_step_T)
        self.K = int(number_of_samples_K)
        self.param_exploration = float(param_exploration)
        self.param_lambda = float(param_lambda)
        self.param_alpha = float(param_alpha)
        self.param_gamma = self.param_lambda * (1.0 - self.param_alpha)
        self.Sigma = sigma
        self.stage_cost_weight = np.asarray(stage_cost_weight, np.float64)
        self.terminal_cost_weight = np.asarray(terminal_cost_weight,
                                               np.float64)
        self.visualize_optimal_traj = visualize_optimal_traj
        self.visualze_sampled_trajs = visualze_sampled_trajs
        self.delta_t = float(delta_t)
        self.ref_path = np.asarray(ref_path, dtype=np.float64)
        self.l1 = 1
        self.l2 = 1

        # warm start (control.py:59) + frozen waypoint index (control.py:65)
        self.u_prev = np.array([[10.0, -2.0] for _ in range(self.T)])
        self.prev_waypoints_idx = 0

        self._backend = backend
        self._device = resolve_device(device)
        self._rng = rng
        self._arm = ArmParams()
        self._cfg = MPPIConfig(
            horizon=self.T,
            num_samples=self.K,
            exploration=self.param_exploration,
            lam=self.param_lambda,
            alpha=self.param_alpha,
            sigma=tuple(tuple(float(v) for v in row) for row in sigma),
            stage_cost_weight=tuple(float(v)
                                    for v in self.stage_cost_weight),
            terminal_cost_weight=tuple(float(v)
                                       for v in self.terminal_cost_weight),
            delta_t=self.delta_t,
            search_idx_len=int(search_idx_len),
            filter_window=int(filter_window),
        )
        self._ref_dev = self._tensor(self.ref_path)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self._device)

    # -- noise (control.py:154-164; quirk Q8 global-RNG default) ------------
    def _calc_epsilon(self, sigma, size_sample, size_time_step, size_dim_u):
        """Reference-identical sampling: multivariate normal, (K, T, 2)."""
        sigma = np.asarray(sigma, dtype=np.float64)
        if (sigma.shape[0] != sigma.shape[1]
                or size_dim_u != sigma.shape[0]):
            raise ValueError(
                "sigma must be a square matrix with the size of dim_u.")
        mu = np.zeros(size_dim_u)
        src = self._rng if self._rng is not None else np.random
        return src.multivariate_normal(mu, sigma,
                                       (size_sample, size_time_step))

    def calc_control_input(self, observed_x) -> Tuple[np.ndarray, ...]:
        """One MPPI solve (control.py:67-152).

        Returns ``(u0, u_seq, optimal_traj, sampled_traj_list)``: because
        the reference shifts the aliased ``u_prev`` in place before
        returning (control.py:148-152), ``u0`` and ``u_seq`` come from the
        SHIFTED sequence, while the visualisation re-rollouts use the
        pre-shift update (quirks Q3/Q4).  Raises ``IndexError`` at the path
        end (control.py:76-78).
        """
        obs = self._tensor(np.asarray(observed_x).reshape(-1))
        eps = self._tensor(self._calc_epsilon(self.Sigma, self.K, self.T,
                                              self.dim_u))
        u_prev_in = self._tensor(self.u_prev)
        state = MPPIState(u_prev=u_prev_in, wp_idx=torch.tensor(
            self.prev_waypoints_idx, dtype=torch.int64, device=self._device))
        res = solve(self._arm, self._cfg, self._ref_dev, obs, state, eps=eps,
                    backend=self._backend)

        # the reference advances prev_waypoints_idx, then raises BEFORE
        # touching u_prev (control.py:75-78)
        self.prev_waypoints_idx = int(res.state.wp_idx)
        if bool(res.path_end):
            print("[ERROR] Reached the end of the reference path.")
            raise IndexError

        optimal_traj = np.zeros((self.T, self.dim_x))
        sampled_traj_list = np.zeros((self.K, self.T, self.dim_x))
        if self.visualize_optimal_traj or self.visualze_sampled_trajs:
            viz = viz_rollouts(self._arm, self._cfg, obs, res.u_seq,
                               u_prev_in, res.eps, res.costs)
            if self.visualize_optimal_traj:
                optimal_traj = viz.optimal_traj.cpu().numpy()
            if self.visualze_sampled_trajs:
                sampled_traj_list = viz.sampled_trajs.cpu().numpy()

        # warm-start shift (control.py:147-149); the returned sequence is the
        # shifted one (aliasing, Q3)
        self.u_prev = res.state.u_prev.cpu().numpy().astype(np.float64)
        u0 = res.u0.cpu().numpy().astype(np.float64)
        return u0, self.u_prev.copy(), optimal_traj, sampled_traj_list
