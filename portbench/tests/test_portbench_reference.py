"""The frozen reference against the port's plain versions, at a small size
on the CPU: the same stream, the same arm, the same median, the same
step."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mppi_robotarm_tpu_torch import config as port_config
from mppi_robotarm_tpu_torch.models import arm as port_arm
from mppi_robotarm_tpu_torch.ops import cuda_rollout, cuda_sim, filters
from mppi_robotarm_tpu_torch.sim.paths import synth_circle_path
from portbench import inputs
from portbench.reference import arm, mppi, philox

ROOT = Path(__file__).resolve().parents[2]


def small():
    P = json.loads((ROOT / "portbench/configs/arm_k1024_h50.json")
                   .read_text())
    P["mppi"].update(num_samples=24, horizon=7)
    arm_p, cfg, sim = port_config.config_from_json(json.dumps(
        {k: P[k] for k in ("arm", "mppi", "sim")}))
    return P, arm_p, cfg, sim


def test_philox_stream_is_the_ports_bit_for_bit():
    P, _, cfg, _ = small()
    seed = torch.tensor([3, 2 ** 31 - 1, 12345], dtype=torch.int64)
    step = torch.tensor([0, 7, 3999], dtype=torch.int64)
    ours = philox.epsilon(seed, step, cfg.num_samples, cfg.horizon,
                          P["mppi"]["sigma"], torch.float32)
    port = cuda_rollout.philox_epsilon_batch(seed, step, torch.zeros_like(
        seed), cfg.num_samples, cfg)
    assert torch.equal(ours, port)


def test_median_is_the_ports_bit_for_bit():
    x = torch.randn(5, 13, 2, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    for size in (1, 2, 5, 10, 26):
        want = torch.stack([filters.median_filter_reflect(x[b], size)
                            for b in range(5)])
        assert torch.equal(mppi.median_reflect(x, size), want)


def test_arm_step_and_host_plant_are_the_ports():
    P, arm_p, _, sim = small()
    g = torch.Generator().manual_seed(2)
    q1, q2, dq1, dq2, u1, u2 = torch.randn(6, 9, generator=g,
                                           dtype=torch.float64)
    want = port_arm.arm_step(q1, q2, dq1, dq2, u1, u2, 0.003, arm_p)
    got = arm.step(P["arm"], q1, q2, dq1, dq2, u1, u2, 0.003)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-15, atol=1e-15)
    host = arm.step_host(P["arm"], (q1[0], q2[0], dq1[0], dq2[0]),
                         (u1[0], u2[0]), 0.003)
    np.testing.assert_allclose(host, [float(v[0]) for v in want],
                               rtol=1e-14, atol=1e-14)


def test_circle_path_is_the_ports():
    np.testing.assert_allclose(inputs.circle_path(500),
                               synth_circle_path(500), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("steps", [1, 5])
def test_loop_step_follows_the_ports_plain_loop(steps):
    """The port's plain whole-loop version, float32, against the
    reference's step in float64 from each of the port's states."""
    P, arm_p, cfg, sim = small()
    ref = torch.as_tensor(inputs.circle_path(300))
    q0 = torch.tensor([sim.q0], dtype=torch.float32)
    dq0 = torch.zeros(1, 2)
    u0 = torch.tensor(cfg.warm_start).repeat(1, cfg.horizon, 1)
    rows, _ = cuda_sim.fused_sim_reference(
        arm_p, cfg, sim, ref, q0, dq0, u0, torch.zeros(1, dtype=torch.int64),
        torch.tensor([11]), steps + 1)
    rows = rows[0]
    # the state before the last step, as the program left it
    _, u_last = cuda_sim.fused_sim_reference(
        arm_p, cfg, sim, ref, q0, dq0, u0, torch.zeros(1, dtype=torch.int64),
        torch.tensor([11]), steps)
    prev = rows[steps - 1]
    st = {"q": prev[None, 0:2], "dq": prev[None, 2:4], "u_prev": u_last,
          "wp": prev[None, 6].long(), "done": torch.zeros(1, dtype=bool),
          "seed": torch.tensor([11]), "step": torch.tensor([steps])}
    r = mppi.loop_step(P, ref, st, torch.float64)
    last = rows[steps]
    assert int(r["wp"][0]) == int(last[6])
    torch.testing.assert_close(r["q"][0].float(), last[0:2], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(r["u"][0].float(), last[4:6], rtol=1e-4,
                               atol=1e-3)
    for i, k in zip(range(8, 12), ("cost_min", "cost_mean", "ess",
                                   "entropy")):
        torch.testing.assert_close(r[k][0].float(), last[i], rtol=1e-4,
                                   atol=1e-4)
