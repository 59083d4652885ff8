"""The per-step solve path of the port (``backend="cuda"``, here on CPU
tensors, so through the solve kernels' plain twin) against the JAX package:
``solve`` against ``solve(backend='xla')``, the closed loop against a loop
of ``sim_step(backend='xla')``, and the batch against its scenarios.

Tolerances: the cuda backend rolls out in float32 with the trig carry where
JAX's XLA path uses the direct trig form, so one solve agrees to ulp level
(costs rtol 2e-5, controls atol 2e-5); through the mildly chaotic loop the
differences grow about 4x a step, hence q within 2e-6·4^i and u within
2e-5·4^i at step i, the bands of tests/test_pallas_sim.py.  A batched run
and the run of each of its scenarios alone are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu.sim.loop as jloop
import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch import convert
from mppi_robotarm_tpu_torch.ops import cuda_solve
from mppi_robotarm_tpu_torch.sim import loop as ploop
from _torch_port_helpers import configs, eps_noise, n, t

JARM, JSIM = J.ArmParams(), J.SimConfig()
PARM, PSIM = P.ArmParams(), P.SimConfig()
F32 = torch.float32
Q_TOL, U_TOL = 2e-6, 2e-5


@pytest.mark.parametrize("filter_window", [10, 25])
def test_solve_cuda_matches_jax_xla(ref_path, filter_window):
    """filter_window 10 fuses the median into the kernel; 25 > 2T leaves it
    to the solver, as JAX's pallas branch does."""
    cj, cp = configs(256, 10, filter_window=filter_window)
    ref = np.asarray(ref_path, np.float32)
    eps = eps_noise(filter_window, (256, 10, 2))
    obs = np.array([1.15, -1.27, 0.3, -0.1], np.float32)
    js = J.init_state(cj, dtype=jnp.float32)._replace(
        wp_idx=jnp.asarray(4, jnp.int32))
    rj = J.solve(JARM, cj, jnp.asarray(ref), jnp.asarray(obs), js,
                 eps=jnp.asarray(eps), backend="xla")
    ps = P.init_state(cp, device="cpu")._replace(wp_idx=torch.tensor(4))
    rp = P.solve(PARM, cp, t(ref, F32), t(obs, F32), ps, eps=t(eps, F32),
                 backend="cuda")
    np.testing.assert_allclose(n(rp.costs), np.asarray(rj.costs), rtol=2e-5)
    np.testing.assert_allclose(n(rp.u_seq), np.asarray(rj.u_seq), atol=U_TOL)
    np.testing.assert_allclose(n(rp.u0), np.asarray(rj.u0), atol=U_TOL)
    np.testing.assert_allclose(n(rp.weights), np.asarray(rj.weights),
                               atol=1e-6)
    assert int(rp.state.wp_idx) == int(rj.state.wp_idx)
    assert bool(rp.path_end) == bool(rj.path_end)
    np.testing.assert_array_equal(n(rp.eps), eps)


def test_solve_cuda_seeded_draws_the_stream(ref_path):
    """A seeded cuda solve returns no noise unless asked, and the noise it
    draws is the eager loop's philox_epsilon(seed, step)."""
    from mppi_robotarm_tpu_torch.ops.cuda_rollout import philox_epsilon

    _, cp = configs(128, 8)
    ref = t(np.asarray(ref_path), F32)
    obs = t(np.array([1.15, -1.27, 0.0, 0.0]), F32)
    st = P.init_state(cp, device="cpu")
    quiet = P.solve(PARM, cp, ref, obs, st, backend="cuda", seed=11, step=4)
    loud = P.solve(PARM, cp, ref, obs, st, backend="cuda", seed=11, step=4,
                   want_eps=True)
    assert quiet.eps is None
    assert torch.equal(loud.eps, philox_epsilon(11, 4, cp))
    assert torch.equal(quiet.u_seq, loud.u_seq)
    fed = P.solve(PARM, cp, ref, obs, st, backend="cuda", eps=loud.eps)
    assert torch.equal(fed.u_seq, loud.u_seq)
    with pytest.raises(ValueError):
        P.solve(PARM, cp, ref, obs, st, backend="cuda")
    with pytest.raises(ValueError):
        P.solve(PARM, cp, ref, obs, st, backend="cuda", seed=1,
                generator=torch.Generator())
    with pytest.raises(ValueError):
        P.solve(PARM, cp, ref, obs, st, backend="tpu", seed=1)


def test_simulate_cuda_matches_jax_sim_step_loop(ref_path):
    """The whole slice: 8 closed-loop steps on injected noise."""
    cj, cp = configs(128, 12)
    steps = 8
    ref = np.asarray(ref_path, np.float32)
    eps = eps_noise(8, (steps, 128, 12, 2))
    js = J.init_sim(cj, JSIM, jax.random.PRNGKey(0), dtype=jnp.float32)
    jrows = []
    for i in range(steps):
        js, _ = jloop.sim_step(JARM, cj, JSIM, jnp.asarray(ref), js,
                                    eps=jnp.asarray(eps[i]), backend="xla")
        jrows.append((np.asarray(js.q), np.asarray(js.mppi.u_prev[0]),
                      int(js.mppi.wp_idx), bool(js.done)))
    before = cuda_solve.LAUNCHES
    final, rec = P.simulate(PARM, cp, PSIM, t(ref, F32),
                            P.init_sim(cp, PSIM, 0, device="cpu"), steps,
                            eps_per_step=t(eps, F32), backend="cuda")
    assert cuda_solve.LAUNCHES == before          # CPU tensors: the twin
    for i, (q, u0, wp, done) in enumerate(jrows):
        np.testing.assert_allclose(n(rec.q[i]), q, atol=Q_TOL * 4 ** i,
                                   err_msg=f"q step {i}")
        np.testing.assert_allclose(n(rec.u[i]), u0, atol=U_TOL * 4 ** i,
                                   err_msg=f"u step {i}")
        assert int(rec.wp_idx[i]) == wp and bool(rec.done[i]) == done
    assert int(final.step) == steps and final.seed == 0
    np.testing.assert_allclose(n(rec.ref_xy), ref[1:steps + 1, :2])


def _batch(cp, seeds=(5, 9, 11, 2)):
    q0 = (torch.tensor([PSIM.q0] * len(seeds))
          + 0.02 * torch.arange(len(seeds), dtype=F32)[:, None])
    return P.init_sim_batch(cp, PSIM, list(seeds), q0=q0, device="cpu")


def test_simulate_batch_cuda_equals_each_scenario_alone(ref_path):
    _, cp = configs(100, 10)
    ref = t(np.asarray(ref_path), F32)
    states = _batch(cp)._replace(step=torch.tensor([0, 3, 0, 7]))
    final, rec = P.simulate_batch(PARM, cp, PSIM, ref, states, 6,
                                  backend="cuda")
    assert rec.q.shape == (6, 4, 2) and rec.cost_min.shape == (6, 4)
    for b in range(4):
        one = ploop._scenario(states, b, int(states.seed[b]))
        f1, r1 = P.simulate(PARM, cp, PSIM, ref, one, 6, backend="cuda")
        for field, a, c in zip(rec._fields, rec, r1):
            assert torch.equal(a[:, b], c), (b, field)
        for a, c in zip((final.q, final.dq, final.mppi.u_prev,
                         final.mppi.wp_idx, final.step, final.done),
                        (f1.q, f1.dq, f1.mppi.u_prev, f1.mppi.wp_idx,
                         f1.step, f1.done)):
            assert torch.equal(a[b], c)
    assert torch.equal(final.seed, states.seed)


def test_simulate_batch_eager_matches_cuda(ref_path):
    _, cp = configs(128, 8)
    ref = t(np.asarray(ref_path), F32)
    states = _batch(cp, (1, 2, 3))
    _, rc = P.simulate_batch(PARM, cp, PSIM, ref, states, 6, backend="cuda")
    _, re_ = P.simulate_batch(PARM, cp, PSIM, ref, states, 6)
    for i in range(6):
        np.testing.assert_allclose(n(re_.q[i]), n(rc.q[i]),
                                   atol=Q_TOL * 4 ** i, err_msg=f"q {i}")
        np.testing.assert_allclose(n(re_.u[i]), n(rc.u[i]),
                                   atol=U_TOL * 4 ** i, err_msg=f"u {i}")
    np.testing.assert_array_equal(n(re_.wp_idx), n(rc.wp_idx))
    np.testing.assert_array_equal(n(re_.done), n(rc.done))
    np.testing.assert_array_equal(n(re_.ref_xy), n(rc.ref_xy))
    with pytest.raises(ValueError):
        P.simulate_batch(PARM, cp, PSIM, ref, states, 1, backend="xla")


def test_simulate_batch_path_end_freeze(ref_path):
    """A 40-waypoint arc trips the Q6 freeze in every scenario: frozen
    rows keep the state and zero the u and cost lanes."""
    _, cp = configs(128, 6)
    short = t(P.synth_circle_path(40, revolutions=0.02), F32)
    _, rec = P.simulate_batch(PARM, cp, PSIM, short, _batch(cp, (0, 1)),
                              120, backend="cuda")
    done = n(rec.done)
    assert done[-1].all()
    for b in range(2):
        first = int(np.argmax(done[:, b]))
        assert done[first:, b].all()
        assert (n(rec.q[first:, b]) == n(rec.q[first, b])).all()
        assert (n(rec.u[first:, b]) == 0).all()
        assert (n(rec.cost_min[first:, b]) == 0).all()


def test_solve_batched_equals_per_scenario_solve(ref_path):
    _, cp = configs(128, 8)
    ref = t(np.asarray(ref_path), F32)
    states = _batch(cp, (4, 8))
    obs = torch.cat([states.q, states.dq], dim=-1)
    res = P.solve_batched(PARM, cp, ref, obs, states.mppi,
                          seeds=states.seed, step=torch.tensor([2, 6]))
    assert res.eps is None and res.u0.shape == (2, 2)
    for b, step in enumerate((2, 6)):
        one = P.solve(PARM, cp, ref, obs[b],
                      P.MPPIState(states.mppi.u_prev[b],
                                  states.mppi.wp_idx[b]),
                      backend="cuda", seed=int(states.seed[b]), step=step)
        assert torch.equal(res.u_seq[b], one.u_seq)
        assert torch.equal(res.costs[b], one.costs)
        assert torch.equal(res.state.wp_idx[b], one.state.wp_idx)
    with pytest.raises(ValueError):
        P.solve_batched(PARM, cp, ref, obs, states.mppi)


def test_sim_step_cuda_single_step(ref_path):
    _, cp = configs(100, 8)
    ref = t(np.asarray(ref_path), F32)
    s0 = P.init_sim(cp, PSIM, seed=3, device="cpu")
    nxt, res = ploop.sim_step(PARM, cp, PSIM, ref, s0, backend="cuda")
    _, rec = P.simulate(PARM, cp, PSIM, ref, s0, 1, backend="cuda")
    assert nxt.seed == 3 and int(nxt.step) == 1
    assert res.u0.shape == (2,) and res.costs.shape == (100,)
    assert res.eps is None
    assert torch.equal(nxt.q, rec.q[0]) and torch.equal(res.u0, rec.u[0])


def test_init_sim_batch_matches_jax_via_convert():
    jarm, jcfg, jsim = J.benchmark_preset()
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    q0 = np.linspace(0.0, 0.1, 10).reshape(5, 2) + np.asarray(jsim.q0)
    js = jloop.init_sim_batch(jcfg, jsim, keys, q0=q0)
    ps = convert.sim_state_batch_from_numpy(
        np.asarray(js.step), np.asarray(js.q), np.asarray(js.dq),
        np.asarray(js.mppi.u_prev), np.asarray(js.mppi.wp_idx),
        np.asarray(jax.random.key_data(js.key)), np.asarray(js.done),
        device="cpu")
    seeds = [convert.seed_from_key_data(k)
             for k in np.asarray(jax.random.key_data(keys))]
    ref = P.init_sim_batch(P.benchmark_preset()[1], P.SimConfig(), seeds,
                           q0=torch.tensor(q0, dtype=F32), device="cpu")
    for a, b in zip(ps, ref):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(ps.mppi, ref.mppi))
    assert ref.seed.tolist() == seeds
    assert ref.mppi.u_prev.shape == (5, jcfg.horizon, 2)
