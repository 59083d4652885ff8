"""The port's closed loops against the JAX package: the eager loop against
``simulate_python``, the fused loop's plain twin against ``pallas_sim_run``
(interpret mode), chaining, the path-end freeze and state conversion."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu.ops.pallas_sim as jps
import mppi_robotarm_tpu_torch as P
import mppi_robotarm_tpu_torch.sim.loop as ploop
from mppi_robotarm_tpu_torch import convert
from mppi_robotarm_tpu_torch.ops import cuda_sim
from _torch_port_helpers import configs, eps_noise, n, t

JARM, JSIM = J.ArmParams(), J.SimConfig()
PARM, PSIM = P.ArmParams(), P.SimConfig()
F32 = torch.float32


def _jax_fused(cfg, ref, steps, eps):
    rec, ufin = jps.pallas_sim_run(
        JARM, cfg, JSIM, jnp.asarray(ref), jnp.asarray(JSIM.q0),
        jnp.asarray(JSIM.dq0),
        jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32), (cfg.horizon, 1)),
        0, 0, steps, eps=jnp.asarray(eps), interpret=True)
    return np.asarray(rec), np.asarray(ufin)


def _twin_fused(cfg, ref, steps, eps):
    rec, ufin = cuda_sim.fused_sim_run(
        PARM, cfg, PSIM, t(ref, F32), t(PSIM.q0, F32), t(PSIM.dq0, F32),
        t(cfg.warm_start, F32).repeat(cfg.horizon, 1), 0, 0, steps,
        eps=None if eps is None else t(eps, F32))
    return n(rec), n(ufin)


def _assert_fused_close(rec_p, rec_j, steps):
    """The bands of tests/test_pallas_sim.py:30-63: ulp-level differences
    grow about 4x per step through the mildly chaotic loop."""
    for i in range(steps):
        np.testing.assert_allclose(rec_p[i, 0:2], rec_j[i, 0:2],
                                   atol=2e-6 * 4 ** i, err_msg=f"q step {i}")
        np.testing.assert_allclose(rec_p[i, 4:6], rec_j[i, 4:6],
                                   atol=2e-5 * 4 ** i, err_msg=f"u step {i}")
    np.testing.assert_array_equal(rec_p[:, 6:8], rec_j[:, 6:8])
    np.testing.assert_allclose(rec_p[0, 8:12], rec_j[0, 8:12], rtol=1e-4)


@pytest.mark.parametrize("K,H,steps", [(128, 8, 6), (100, 6, 4)])
def test_fused_twin_matches_jax_kernel(ref_path, K, H, steps):
    cj, cp = configs(K, H)
    ref = np.asarray(ref_path[:400], np.float32)
    eps = eps_noise(K + H, (steps, K, H, 2))
    rec_j, _ = _jax_fused(cj, ref, steps, eps)
    rec_p, _ = _twin_fused(cp, ref, steps, eps)
    _assert_fused_close(rec_p, rec_j, steps)
    assert (rec_p[:, 7] == 0.0).all()


def test_fused_twin_path_end_freeze_matches_jax():
    """A 40-waypoint arc trips the Q6 freeze: the done flags, the frozen
    index and the frozen rows agree with the JAX kernel."""
    cj, cp = configs(128, 6)
    short = J.synth_circle_path(40, revolutions=0.02)
    steps = 200
    eps = eps_noise(40, (steps, 128, 6, 2))
    rec_j, _ = _jax_fused(cj, short, steps, eps)
    rec_p, _ = _twin_fused(cp, short, steps, eps)
    np.testing.assert_array_equal(rec_p[:, 7], rec_j[:, 7])
    np.testing.assert_array_equal(rec_p[:, 6], rec_j[:, 6])
    assert rec_p[-1, 7] == 1.0
    first = int(np.argmax(rec_p[:, 7] > 0.5))
    frozen = rec_p[first:]
    assert np.all(frozen[:, 0:4] == frozen[0, 0:4])
    np.testing.assert_array_equal(frozen[:, 4:12], rec_j[first:, 4:12])
    assert np.all(frozen[:, 4:6] == 0.0) and np.all(frozen[:, 8:12] == 0.0)
    # the frozen state is reached after ~50 chaotic steps, where the
    # 2e-6·4^i band of the short runs no longer bounds anything; the two
    # land within 1e-2 of each other
    np.testing.assert_allclose(frozen[:, 0:4], rec_j[first:, 0:4], atol=1e-2)


def test_fused_twin_on_cpu_launches_nothing_and_checks_config(ref_path):
    _, cp = configs(64, 6)
    before = cuda_sim.LAUNCHES
    rec, ufin = _twin_fused(cp, np.asarray(ref_path[:100], np.float32), 2,
                            None)
    assert cuda_sim.LAUNCHES == before
    assert rec.shape == (2, 12) and ufin.shape == (6, 2)
    for bad in (dataclasses.replace(cp, filter_window=13),
                dataclasses.replace(cp, num_samples=cuda_sim.MAX_SAMPLES + 1)):
        with pytest.raises(ValueError):
            _twin_fused(bad, np.asarray(ref_path[:100], np.float32), 1, None)


def test_simulate_matches_jax_simulate_python(ref_path):
    """The eager loop, float64, injected noise, 20 steps."""
    cj, cp = configs(100, 30)
    steps = 20
    eps = eps_noise(20, (steps, 100, 30, 2), np.float64)
    s0 = J.init_sim(cj, JSIM, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, recs = J.simulate_python(JARM, cj, JSIM, jnp.asarray(ref_path), s0,
                                steps, eps_per_step=[jnp.asarray(e)
                                                     for e in eps])
    p0 = P.init_sim(cp, PSIM, 0, dtype=torch.float64, device="cpu")
    final, rec = P.simulate(PARM, cp, PSIM, t(ref_path), p0, steps,
                            eps_per_step=t(eps))
    _, precs = P.simulate_python(PARM, cp, PSIM, t(ref_path), p0, steps,
                                 eps_per_step=t(eps))
    for i in range(steps):
        np.testing.assert_allclose(n(rec.q[i]), np.asarray(recs[i][0]),
                                   atol=1e-9, rtol=0, err_msg=f"q step {i}")
        np.testing.assert_allclose(n(rec.u[i]), np.asarray(recs[i][2]),
                                   atol=1e-7, rtol=0, err_msg=f"u step {i}")
        assert int(rec.wp_idx[i]) == recs[i][3]
        np.testing.assert_array_equal(n(precs[i][0]), n(rec.q[i]))
    assert int(final.step) == steps and not bool(final.done)
    np.testing.assert_allclose(n(rec.ref_xy), np.asarray(ref_path)[1:21, :2])


def _line_path_ending_at_ee():
    """A straight 50-point path whose last waypoint is the initial EE."""
    q1, q2 = PSIM.q0
    ex = np.cos(q1) + np.cos(q1 + q2)
    ey = np.sin(q1) + np.sin(q1 + q2)
    s = np.linspace(-0.2, 0.0, 50)
    return np.stack([ex + s, ey + 0.5 * s, np.zeros(50), np.zeros(50)], 1)


def test_path_end_raises_like_jax():
    path = _line_path_ending_at_ee()
    cj, cp = configs(32, 5)
    eps = eps_noise(3, (2, 32, 5, 2), np.float64)
    s0 = J.init_sim(cj, JSIM, jax.random.PRNGKey(0), dtype=jnp.float64)
    s0 = s0._replace(mppi=s0.mppi._replace(wp_idx=jnp.asarray(45,
                                                               jnp.int32)))
    with pytest.raises(IndexError):
        J.simulate_python(JARM, cj, JSIM, jnp.asarray(path), s0, 2,
                          eps_per_step=[jnp.asarray(e) for e in eps])
    p0 = P.init_sim(cp, PSIM, 0, dtype=torch.float64, device="cpu")
    p0 = p0._replace(mppi=p0.mppi._replace(wp_idx=torch.tensor(45)))
    with pytest.raises(IndexError):
        P.simulate_python(PARM, cp, PSIM, t(path), p0, 2,
                          eps_per_step=t(eps))
    # the eager scan-style loop freezes instead, with the Q6 record layout
    final, rec = P.simulate(PARM, cp, PSIM, t(path), p0, 2,
                            eps_per_step=t(eps))
    assert bool(final.done) and int(final.step) == 0
    assert n(rec.done).all() and (n(rec.u) == 0).all()
    np.testing.assert_array_equal(n(rec.q[-1]), np.asarray(PSIM.q0))


def test_simulate_fused_wrapper_matches_jax(ref_path, monkeypatch):
    """The public fused loop (twin on CPU tensors) against the JAX fused
    wrapper on the same noise: records, derived fields and final state."""
    cj, cp = configs(128, 8)
    ref = np.asarray(ref_path[:400], np.float32)
    steps = 5
    eps = eps_noise(5, (steps, 128, 8, 2))
    orig = jps.pallas_sim_run
    monkeypatch.setattr(jps, "pallas_sim_run",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jfinal, jrec = J.simulate_fused(JARM, cj, JSIM, jnp.asarray(ref),
                                    J.init_sim(cj, JSIM,
                                               jax.random.PRNGKey(0)),
                                    steps, eps_per_step=eps)
    pfinal, prec = P.simulate_fused(PARM, cp, PSIM, t(ref, F32),
                                    P.init_sim(cp, PSIM, 0, device="cpu"),
                                    steps, eps_per_step=t(eps, F32))
    prec = convert.records_to_numpy(prec)
    for f in ("q", "dq", "ee", "elbow"):
        np.testing.assert_allclose(getattr(prec, f), np.asarray(
            getattr(jrec, f)), atol=2e-6 * 4 ** steps, err_msg=f)
    for f in ("ref_xy", "wp_idx", "done"):
        np.testing.assert_array_equal(getattr(prec, f),
                                      np.asarray(getattr(jrec, f)),
                                      err_msg=f)
    assert int(pfinal.step) == int(jfinal.step) == steps
    assert int(pfinal.mppi.wp_idx) == int(jfinal.mppi.wp_idx)
    np.testing.assert_allclose(n(pfinal.mppi.u_prev),
                               np.asarray(jfinal.mppi.u_prev), atol=0.05)
    assert pfinal.seed == 0


def test_fused_twin_chained_equals_single_prng(ref_path, monkeypatch):
    """PRNG mode: 3 + 3 chained steps equal one 6-step run bitwise, and so
    does the automatic chaining past _FUSED_MAX_STEPS."""
    _, cp = configs(128, 8)
    ref = t(np.asarray(ref_path[:400]), F32)
    s0 = P.init_sim(cp, PSIM, seed=11, device="cpu")
    _, full = P.simulate_fused(PARM, cp, PSIM, ref, s0, 6)
    s, parts = s0, []
    for k in (3, 3):
        s, r = P.simulate_fused(PARM, cp, PSIM, ref, s, k)
        parts.append(r)
    monkeypatch.setattr(ploop, "_FUSED_MAX_STEPS", 2)
    s_auto, auto = P.simulate_fused(PARM, cp, PSIM, ref, s0, 6)
    for f, a, b1, b2, c in zip(full._fields, full, *parts, auto):
        assert torch.equal(a, torch.cat([b1, b2])), f
        assert torch.equal(a, c), f
    assert int(s.step) == int(s_auto.step) == 6 and s.seed == 11
    assert torch.equal(s.mppi.u_prev, s_auto.mppi.u_prev)


def test_eager_and_fused_draw_the_same_noise(ref_path):
    """Without injected noise the eager loop and the fused twin read the
    same Philox stream, so they agree within the fused parity band."""
    _, cp = configs(128, 8)
    ref = t(np.asarray(ref_path[:400]), F32)
    s0 = P.init_sim(cp, PSIM, seed=5, dtype=F32, device="cpu")
    _, fused = P.simulate_fused(PARM, cp, PSIM, ref, s0, 5)
    _, eager = P.simulate(PARM, cp, PSIM, ref, s0, 5)
    for i in range(5):
        np.testing.assert_allclose(n(eager.q[i]), n(fused.q[i]),
                                   atol=2e-6 * 4 ** i, err_msg=f"q {i}")
    np.testing.assert_array_equal(n(eager.wp_idx), n(fused.wp_idx))


def test_convert_round_trip():
    jarm, jcfg, jsim = J.benchmark_preset()
    assert (convert.arm_from_jax_config(jarm),
            convert.mppi_from_jax_config(jcfg),
            convert.sim_from_jax_config(jsim)) == P.benchmark_preset()
    js = J.init_sim(jcfg, jsim, jax.random.PRNGKey(3))
    ps = convert.sim_state_from_numpy(
        np.asarray(js.step), np.asarray(js.q), np.asarray(js.dq),
        np.asarray(js.mppi.u_prev), np.asarray(js.mppi.wp_idx),
        np.asarray(jax.random.key_data(js.key)), np.asarray(js.done),
        device="cpu")
    ref = P.init_sim(P.benchmark_preset()[1], P.SimConfig(), seed=3,
                     device="cpu")
    assert ps.seed == ref.seed == 3
    for a, b in zip(ps, ref):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(ps.mppi, ref.mppi))
    assert convert.seed_from_key_data(np.array([7, 0xFFFFFFFF],
                                               np.uint32)) == 0x7FFFFFFF
