"""The frozen reference against the port's plain versions, at a small size
on the CPU: the same stream, the same arm, the same median, the same
step; and the reference's solve handed the noise a caller drew, against
the port's eager solve handed the same."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as port
from mppi_robotarm_tpu_torch import config as port_config
from mppi_robotarm_tpu_torch.models import arm as port_arm
from mppi_robotarm_tpu_torch.ops import cuda_rollout, cuda_sim, filters
from mppi_robotarm_tpu_torch.sim.paths import synth_circle_path
from portbench import harness, inputs, judge
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


# ---- injected noise --------------------------------------------------------

F64 = torch.float64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_philox_stream_injected_gives_the_same_bits(dtype):
    """``solve(eps=)`` handed the stream it draws itself, in its dtype,
    and ``loop_step`` handed it in the state, give every output's bits."""
    P, *_ = small()
    mp = P["mppi"]
    B, K, T = 3, mp["num_samples"], mp["horizon"]
    ref = torch.as_tensor(inputs.circle_path(300))
    g = torch.Generator().manual_seed(5)
    st = {"q": torch.tensor([P["sim"]["q0"]] * B) + 0.01 * torch.randn(
              B, 2, generator=g),
          "dq": torch.zeros(B, 2),
          "u_prev": torch.tensor(mp["warm_start"]).repeat(B, T, 1),
          "wp": torch.tensor([0, 3, 7]), "done": torch.zeros(B, dtype=bool),
          "seed": torch.tensor([11, 2 ** 31 - 1, 12345]),
          "step": torch.tensor([0, 9, 3999])}
    eps = philox.epsilon(st["seed"], st["step"], K, T, mp["sigma"], dtype)
    args = (P, ref, st["q"], st["dq"], st["u_prev"], st["wp"], st["seed"],
            st["step"], dtype)
    for a, b in ((mppi.solve(*args), mppi.solve(*args, eps=eps)),
                 (mppi.loop_step(P, ref, st, dtype),
                  mppi.loop_step(P, ref, {**st, "eps": eps}, dtype))):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _preset(name: str) -> dict:
    """A preset of the port as the reference's configuration dict."""
    fn = getattr(port_config, f"{name}_preset")
    return json.loads(port_config.config_to_json(*fn()))


def eager_calls(P: dict, n: int, seed: int, dtype=F64, rows: int = 400):
    """``n`` closed-loop calls of the port's eager ``solve`` on the CPU,
    each handed noise drawn on the host by NumPy's multivariate normal
    (``compat.py::_calc_epsilon``'s draw), the plant stepped on the host:
    (the path, what each call was handed, what it returned) as the
    judge's cases."""
    arm_p, cfg, _ = port_config.config_from_json(json.dumps(
        {k: P[k] for k in ("arm", "mppi", "sim")}))
    mp = P["mppi"]
    ref = torch.as_tensor(inputs.circle_path(rows), dtype=dtype)
    g = np.random.default_rng(seed)
    state = port.init_state(cfg, dtype=dtype, device="cpu")
    x = (*P["sim"]["q0"], *P["sim"]["dq0"])
    inp, prog = [], []
    for _ in range(n):
        eps = torch.as_tensor(g.multivariate_normal(
            np.zeros(2), np.asarray(mp["sigma"], dtype=np.float64),
            (mp["num_samples"], mp["horizon"])), dtype=dtype)
        xd = torch.tensor(x, dtype=dtype)
        res = port.solve(arm_p, cfg, ref, xd, state, eps=eps,
                         backend="eager")
        inp.append({"q": xd[None, :2], "dq": xd[None, 2:],
                    "u_prev": state.u_prev[None],
                    "wp": state.wp_idx.reshape(1), "eps": eps[None]})
        prog.append({"u0": res.u0[None], "u_new": res.u_seq[None],
                     "u_next": res.state.u_prev[None],
                     "wp": res.state.wp_idx.reshape(1),
                     "path_end": res.path_end.reshape(1),
                     "costs": res.costs[None], "weights": res.weights[None]})
        x = arm.step_host(P["arm"], x, res.u0.numpy(), P["sim"]["dt"],
                          tuple(P["sim"]["disturbance"]))
        state = res.state
    cat = lambda ds: {k: torch.cat([d[k] for d in ds]) for k in ds[0]}
    return ref, cat(inp), cat(prog)


@pytest.mark.parametrize("preset, K, T", [("circle_tracking", 100, 30),
                                          ("benchmark", 1024, 50)])
def test_injected_noise_gives_the_ports_eager_solve(preset, K, T):
    """Handed a NumPy-drawn ε, the reference's float64 solve and the
    port's eager float64 solve agree to 1e-12 in u0, u_new, the costs
    (each relative to itself: they run ~1e7 at cost_scale 1e4) and the
    weights, and pick the same index: at the compat drop-in's K=100, T=30
    (run.py:25-37) and at K=1024, H=50, over closed-loop calls."""
    P = _preset(preset)
    assert (P["mppi"]["num_samples"], P["mppi"]["horizon"]) == (K, T)
    ref, inp, prog = eager_calls(P, 3, seed=2 ** 33 + 1)
    r = mppi.solve(P, ref, inp["q"], inp["dq"], inp["u_prev"], inp["wp"],
                   None, None, F64, eps=inp["eps"])
    assert torch.equal(r["wp"], prog["wp"])
    for k in ("u0", "u_new", "weights"):
        assert (r[k] - prog[k]).abs().max() <= 1e-12, k
    assert ((r["costs"] - prog["costs"]).abs()
            / r["costs"].abs()).max() <= 1e-12


def test_call_readings_judge_injected_calls_by_the_realtime_limits():
    """Eager calls handed NumPy-drawn ε, with ``eps`` in the cases, are
    judged within the real-time cell's limits; their control, the
    reference in bfloat16 given the same ε, fails those limits."""
    P = _preset("benchmark")
    limits = harness.load_cell("arm_k1024_h50.realtime").limits
    ref, inp, prog = eager_calls(P, 6, seed=7)
    calls = judge.kind("calls", harness.ROOT)
    sound = calls.readings(P, ref, inp, prog, F64)
    assert judge.verdict(sound, limits)[0], sound
    assert sound["u_gap"] <= 1e-12 and sound["wp_gap"] == 0
    fake = calls.control(P, ref, inp, torch.bfloat16)
    bad = calls.readings(P, ref, inp, fake, F64)
    assert not judge.verdict(bad, limits)[0], bad
