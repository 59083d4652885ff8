"""The port's drop-in compat layer (``mppi_robotarm_tpu_torch/compat.py``)
against the float64 oracle, as ``tests/test_compat.py`` holds the JAX
package's: every symbol of the reference's API with NumPy in and out, the
controller on the eager backend on the CPU in float64, noise from the
global NumPy RNG (Q8) or ``rng=``, the shifted applied control (Q3), the
path-end ``IndexError``.

The cuda-marked test at the end is chip_smoke phase 19's twin for the
controller on the solve kernel; with the rest of the file it needs no JAX:

    python -m pytest --noconftest tests/test_torch_compat.py -m cuda
"""

import numpy as np
import pytest

from mppi_robotarm_tpu_torch.compat import (
    SYS_PARAMS,
    Arm_Dynamic,
    Controller,
    Feedback_linearization,
    Forward_Kinemetic,
    Inverse_Kinemetic,
    MPPIControllerForPathTracking,
)
from oracle import OracleMPPI, oracle_ddq, oracle_fk, oracle_plant_step

EAGER = dict(backend="eager", device="cpu")    # the CPU's solve backend

RUN_CFG = dict(  # the run.py:25-37 call-site values
    delta_t=0.006,
    horizon_step_T=30,
    number_of_samples_K=100,
    param_exploration=0.0,
    param_lambda=100.0,
    param_alpha=0.98,
    sigma=np.array([[20.0, 0.0], [0.0, 20.0]]),
    stage_cost_weight=np.array([0.5, 0.5, 5.0, 5.0]),
    terminal_cost_weight=np.array([5.0, 5.0, 50.0, 50.0]),
)
Q0 = np.array([1.1522, -1.2661])  # run.py:14


def test_sys_params_values():
    p = SYS_PARAMS()
    assert p == {"Ts": 0.0025, "m1": 1, "m2": 1, "l1": 1, "l2": 1,
                 "lc1": 0.5, "lc2": 0.5, "g": 9.81}


def test_arm_dynamic_matches_oracle():
    gen = np.random.default_rng(3)
    for _ in range(5):
        q, dq, u = gen.normal(size=(3, 2))
        got = Arm_Dynamic(q, dq, u)
        exp = oracle_ddq(q[0], q[1], dq[0], dq[1], u[0], u[1])
        np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_forward_kinemetic_matches_oracle():
    q = np.array([0.7, -0.3])
    x1, y1, x2, y2 = Forward_Kinemetic(q)
    ex, ey = oracle_fk(q[0], q[1])
    np.testing.assert_allclose([x2, y2], [ex, ey], rtol=1e-12)
    np.testing.assert_allclose([x1, y1], [np.cos(0.7), np.sin(0.7)],
                               rtol=1e-12)


def test_inverse_kinemetic_roundtrip():
    """FK(IK(θ)) lands back on the circle point (utils.py:41-62)."""
    for theta in (0.3, 1.5, 4.0):
        r, xe, ye = Inverse_Kinemetic(theta)
        np.testing.assert_allclose(
            [xe, ye], [0.8 + 0.6 * np.cos(theta), 0.8 + 0.6 * np.sin(theta)],
            rtol=1e-12)
        _, _, x2, y2 = Forward_Kinemetic(r)
        np.testing.assert_allclose([x2, y2], [xe, ye], atol=1e-9)


def test_feedback_linearization_inverts_dynamics():
    """u = FL(q, dq, v)  ⇒  Arm_Dynamic(q, dq, u) == v (utils.py:65-84)."""
    gen = np.random.default_rng(5)
    q, dq, v = gen.normal(size=(3, 2))
    u = Feedback_linearization(q, dq, v)
    np.testing.assert_allclose(Arm_Dynamic(q, dq, u), v, rtol=1e-9,
                               atol=1e-12)


def test_pd_controller_law():
    gen = np.random.default_rng(6)
    q, dq, r, dr, ddr = gen.normal(size=(5, 2))
    got = Controller(q, dq, r, dr, ddr)
    exp = ddr - 20.0 * (dq - dr) - 100.0 * (q - r)   # utils.py:87-93
    np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_sigma_validation():
    with pytest.raises(ValueError):
        MPPIControllerForPathTracking(ref_path=np.zeros((10, 4)),
                                      sigma=np.eye(3), **EAGER)


def test_calc_control_input_matches_oracle(ref_path):
    """3 sequential solves + plant steps: u0/u_seq/wp-index parity with the
    oracle, identical noise stream (run.py:48-71 closed-loop semantics)."""
    ctrl = MPPIControllerForPathTracking(
        ref_path=ref_path, visualize_optimal_traj=False,
        rng=np.random.default_rng(7), **RUN_CFG, **EAGER)
    mirror = np.random.default_rng(7)
    oracle = OracleMPPI(ref_path)

    q, dq = Q0.copy(), np.zeros(2)
    for step in range(3):
        obs = np.concatenate([q, dq])
        u0, u_seq, opt, sampled = ctrl.calc_control_input(obs)
        eps = mirror.multivariate_normal(np.zeros(2), RUN_CFG["sigma"],
                                         (100, 30))
        u0_exp, _, S, w = oracle.solve(obs, eps)
        np.testing.assert_allclose(u0, u0_exp, rtol=1e-7, atol=1e-9,
                                   err_msg=f"step {step}")
        # the returned sequence is the SHIFTED one (aliasing quirk Q3)
        np.testing.assert_allclose(u_seq, oracle.u_prev, rtol=1e-7,
                                   atol=1e-9, err_msg=f"step {step}")
        assert ctrl.prev_waypoints_idx == oracle.prev_idx
        assert opt.shape == (30, 4) and not opt.any()       # flag off
        assert sampled.shape == (100, 30, 4) and not sampled.any()
        q, dq = oracle_plant_step(q, dq, u0_exp, 0.003)     # run.py:53-55


def test_viz_outputs_match_reference_semantics(ref_path):
    """optimal_traj / sampled_traj_list reproduce the reference re-rollouts
    including quirk Q4 (controls applied rolled by one, last-first)."""
    ctrl = MPPIControllerForPathTracking(
        ref_path=ref_path, visualize_optimal_traj=True,
        visualze_sampled_trajs=True, rng=np.random.default_rng(11),
        **RUN_CFG, **EAGER)
    mirror = np.random.default_rng(11)
    oracle = OracleMPPI(ref_path)

    obs = np.concatenate([Q0, np.zeros(2)])
    _, _, opt, sampled = ctrl.calc_control_input(obs)
    eps = mirror.multivariate_normal(np.zeros(2), RUN_CFG["sigma"],
                                     (100, 30))
    _, u_new, S, _ = oracle.solve(obs, eps)

    # expected viz: x = F(x, u[t-1]) for t = 0..T-1 (control.py:129-145)
    def re_rollout(u_seq):
        x = obs.copy()
        out = np.zeros((30, 4))
        for t in range(30):
            q_n, dq_n = oracle_plant_step(x[:2], x[2:], u_seq[t - 1], 0.006)
            # controller-internal model: semi-implicit at delta_t
            x = np.concatenate([q_n, dq_n])
            out[t] = x
        return out

    np.testing.assert_allclose(opt, re_rollout(u_new), rtol=1e-6, atol=1e-8)
    exploit_u = np.tile([[10.0, -2.0]], (30, 1))  # warm start, step 1
    for k in (0, 57, 99):
        vk = exploit_u + eps[k]                   # exploration=0.0 (Q9)
        np.testing.assert_allclose(sampled[k], re_rollout(vk), rtol=1e-6,
                                   atol=1e-8, err_msg=f"sample {k}")


def test_path_end_raises_index_error(ref_path):
    ctrl = MPPIControllerForPathTracking(
        ref_path=ref_path, visualize_optimal_traj=False,
        rng=np.random.default_rng(1), **RUN_CFG, **EAGER)
    ctrl.prev_waypoints_idx = ref_path.shape[0] - 5
    # an observed state near the path end → frozen index hits the last row
    r, xe, ye = Inverse_Kinemetic(2.0 * np.pi - 0.01)
    obs = np.concatenate([r, np.zeros(2)])
    with pytest.raises(IndexError):
        ctrl.calc_control_input(obs)
    # u_prev untouched by the failed solve (control.py:76-78 raises early)
    np.testing.assert_array_equal(ctrl.u_prev,
                                  np.tile([[10.0, -2.0]], (30, 1)))


def test_global_rng_default_reproduces_with_np_seed(ref_path):
    """Q8 semantics: the default noise source is the global np.random, so
    np.random.seed makes two runs identical — exactly like the reference."""
    obs = np.concatenate([Q0, np.zeros(2)])
    outs = []
    for _ in range(2):
        np.random.seed(123)
        ctrl = MPPIControllerForPathTracking(
            ref_path=ref_path, visualize_optimal_traj=False, **RUN_CFG,
            **EAGER)
        u0, u_seq, *_ = ctrl.calc_control_input(obs)
        outs.append((u0, u_seq))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_controller_needs_a_card_unless_asked(ref_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MPPIControllerForPathTracking(ref_path=ref_path, **RUN_CFG)
    with pytest.raises(ValueError, match="unknown backend"):
        MPPIControllerForPathTracking(ref_path=ref_path, backend="xla",
                                      device="cpu")


def test_helpers_compute_in_float64_on_the_host():
    """The kinematics helpers return float64 NumPy whatever the default
    device (they are host computations by design)."""
    assert Arm_Dynamic([0.1, 0.2], [0.0, 0.0], [1.0, 2.0]).dtype == np.float64
    r, xe, ye = Inverse_Kinemetic(0.3)
    assert r.dtype == np.float64 and isinstance(xe, float)
    assert Controller(*np.zeros((5, 2))).dtype == np.float64


@pytest.mark.cuda
def test_controller_on_the_card():
    """chip_smoke phase 19: 20 steps of the reference's loop with the
    solve kernel under np.random.seed(0), finite and on the path."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mppi_robotarm_tpu_torch.sim.paths import synth_circle_path

    ref = synth_circle_path(2000, dtype=np.float64)
    np.random.seed(0)
    ctrl = MPPIControllerForPathTracking(
        ref_path=ref, visualize_optimal_traj=True, **RUN_CFG)
    q, dq = Q0.copy(), np.zeros(2)
    err = []
    for k in range(20):
        u0, *_ = ctrl.calc_control_input(np.concatenate([q, dq]))
        dq = dq + 0.003 * Arm_Dynamic(q, dq, u0)
        q = q + 0.003 * dq
        _, _, x2, y2 = Forward_Kinemetic(q)
        err.append(np.hypot(x2 - ref[k + 1, 0], y2 - ref[k + 1, 1]))
    assert np.isfinite(err).all() and np.mean(err) < 0.05


@pytest.mark.parametrize("name,argv", [
    ("track_circle", ["--steps", "5", "--backend", "eager", "--device",
                      "cpu"]),
    ("multi_scenario", ["--batch", "4", "--samples", "16", "--steps", "3",
                        "--device", "cpu"]),
    ("reference_drop_in", ["--steps", "3", "--backend", "eager", "--device",
                           "cpu"]),
    ("sharded_fleet", ["--batch", "4", "--steps", "2", "--device", "cpu"]),
])
def test_examples_run_on_the_cpu(name, argv, tmp_path, monkeypatch):
    """The examples (``python -m mppi_robotarm_tpu_torch.examples.<name>``)
    at small sizes on the CPU: each finishes with finite results."""
    import importlib

    for k in ("MPPI_COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE",
              "RANK"):
        monkeypatch.delenv(k, raising=False)
    mod = importlib.import_module(f"mppi_robotarm_tpu_torch.examples.{name}")
    if name == "track_circle":
        argv = argv + ["--out", str(tmp_path)]
    out = mod.main(argv)
    if name == "track_circle":
        assert np.isfinite(list(out.values())).all()
        assert (tmp_path / "tracking.png").exists()
    elif name == "sharded_fleet":
        d, ok = out
        assert ok and np.isfinite(d).all()
    else:
        assert np.isfinite(out).all() and len(out) > 0
