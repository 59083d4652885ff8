"""The scenario fleet: the fleet kernel's plain twin
(``fused_sim_reference_stacked``) against the JAX package's stacked kernel
(``pallas_sim_run_batched(group>1)`` in interpret mode) and against the
per-scenario twin, and ``simulate_fused_batch`` against the JAX wrapper,
its chaining and its group choice."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu.ops.pallas_sim as jps
import mppi_robotarm_tpu_torch as P
import mppi_robotarm_tpu_torch.sim.loop as ploop
from mppi_robotarm_tpu_torch.ops import cuda_sim
from _torch_port_helpers import configs, eps_noise, n, t

JARM, JSIM = J.ArmParams(), J.SimConfig()
PARM, PSIM = P.ArmParams(), P.SimConfig()
F32 = torch.float32


def _fleet_inputs(cfg, B, frozen_mix):
    """q0 spread per scenario, the warm start, and (when ``frozen_mix``)
    odd scenarios starting at the path's last row of a 120-row slice, so
    frozen and active scenarios share a group (tests/test_pallas_sim.py:
    186-205)."""
    q0 = (np.tile(np.asarray([JSIM.q0], np.float32), (B, 1))
          + 0.005 * np.arange(B, dtype=np.float32)[:, None])
    up = np.tile(np.asarray(cfg.warm_start, np.float32), (B, cfg.horizon, 1))
    wp = np.where(np.arange(B) % 2 == 1, 119, 0) if frozen_mix \
        else np.zeros(B, np.int64)
    return q0, up, wp


def _assert_bands(rec_p, rec_j, steps):
    """q within 2e-6·4^i, u within 2e-5·4^i at step i; wp/done exactly
    (tests/test_pallas_sim.py:30-63), for (B, steps, 12) records."""
    for i in range(steps):
        np.testing.assert_allclose(rec_p[:, i, 0:2], rec_j[:, i, 0:2],
                                   atol=2e-6 * 4 ** i, err_msg=f"q step {i}")
        np.testing.assert_allclose(rec_p[:, i, 4:6], rec_j[:, i, 4:6],
                                   atol=2e-5 * 4 ** i, err_msg=f"u step {i}")
    np.testing.assert_array_equal(rec_p[..., 6:8], rec_j[..., 6:8])


@pytest.mark.parametrize("K,rows,steps,mix", [(128, 120, 6, True),
                                              (100, 300, 5, False)])
def test_stacked_twin_matches_jax_stacked_kernel(ref_path, K, rows, steps,
                                                 mix):
    cj, cp = configs(K, 6)
    B = 4
    ref = np.asarray(ref_path[:rows], np.float32)
    q0, up, wp = _fleet_inputs(cj, B, mix)
    eps = eps_noise(K + rows, (B, steps, K, 6, 2))
    rec_j, ufin_j = jps.pallas_sim_run_batched(
        JARM, cj, JSIM, jnp.asarray(ref), jnp.asarray(q0),
        jnp.zeros((B, 2), jnp.float32), jnp.asarray(up),
        jnp.asarray(wp, jnp.int32), jnp.zeros(B, jnp.int32), steps,
        eps=jnp.asarray(eps), interpret=True, group=4)
    rec_p, ufin_p = cuda_sim.fused_sim_reference_stacked(
        PARM, cp, PSIM, t(ref, F32), t(q0, F32), torch.zeros(B, 2),
        t(up, F32), torch.as_tensor(wp), torch.zeros(B, dtype=torch.int64),
        steps, eps=t(eps, F32))
    rec_j, rec_p = np.asarray(rec_j), n(rec_p)
    _assert_bands(rec_p, rec_j, steps)
    if mix:
        # the frozen scenarios' rows: the start state, zeroed u and stats
        assert rec_p[:, -1, 7].tolist() == [0.0, 1.0, 0.0, 1.0]
        np.testing.assert_array_equal(rec_p[1::2], rec_j[1::2])


@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_stacked_twin_equals_per_scenario_twin(ref_path, noise):
    _, cp = configs(100, 6)
    B, steps = 4, 4
    ref = t(np.asarray(ref_path[:120]), F32)
    q0, up, wp = _fleet_inputs(cp, B, True)
    args = (PARM, cp, PSIM, ref, t(q0, F32), torch.zeros(B, 2), t(up, F32),
            torch.as_tensor(wp), torch.tensor([5, 9, 2, 7]), steps)
    kw = dict(step0=torch.tensor([0, 3, 11, 4]),
              eps=None if noise == "prng"
              else t(eps_noise(8, (B, steps, 100, 6, 2)), F32))
    rec_s, uf_s = cuda_sim.fused_sim_reference_stacked(*args, **kw)
    rec_1, uf_1 = cuda_sim.fused_sim_reference(*args, **kw)
    assert torch.equal(rec_s, rec_1) and torch.equal(uf_s, uf_1)
    # the CPU route of fused_sim_run_batched: group > 1 takes the stacked
    # twin and launches nothing
    before = (cuda_sim.LAUNCHES, cuda_sim.FLEET_LAUNCHES)
    rec_g, _ = cuda_sim.fused_sim_run_batched(*args, group=2, **kw)
    assert torch.equal(rec_g, rec_1)
    assert (cuda_sim.LAUNCHES, cuda_sim.FLEET_LAUNCHES) == before


def test_simulate_fused_batch_matches_jax(ref_path, monkeypatch):
    """The public fleet loop (stacked twin on CPU tensors) against the JAX
    wrapper with interpret patched in (tests/test_pallas_sim.py:326-345):
    the (steps, B, ...) layout and the values in the fused bands."""
    cj, cp = configs(128, 8)
    ref = np.asarray(ref_path[:400], np.float32)
    B, steps = 4, 4
    eps = eps_noise(17, (B, steps, 128, 8, 2))
    orig, groups = jps.pallas_sim_run_batched, []

    def interpreted(*a, **k):
        groups.append(k["group"])
        return orig(*a, **{**k, "interpret": True})

    monkeypatch.setattr(jps, "pallas_sim_run_batched", interpreted)
    jstates = J.init_sim_batch(cj, JSIM, jax.vmap(jax.random.PRNGKey)(
        jnp.arange(B)))
    jfinal, jrec = J.simulate_fused_batch(JARM, cj, JSIM, jnp.asarray(ref),
                                          jstates, steps, eps_per_step=eps)
    pfinal, prec = P.simulate_fused_batch(
        PARM, cp, PSIM, t(ref, F32),
        P.init_sim_batch(cp, PSIM, np.arange(B), device="cpu"), steps,
        eps_per_step=t(eps, F32))
    for f in prec._fields:
        assert tuple(getattr(prec, f).shape) == getattr(jrec, f).shape, f
    for i in range(steps):
        for f, tol in (("q", 2e-6), ("ee", 2e-6), ("u", 2e-5)):
            np.testing.assert_allclose(n(getattr(prec, f)[i]),
                                       np.asarray(getattr(jrec, f)[i]),
                                       atol=tol * 4 ** i, err_msg=f"{f} {i}")
    for f in ("ref_xy", "wp_idx", "done"):
        np.testing.assert_array_equal(n(getattr(prec, f)),
                                      np.asarray(getattr(jrec, f)), err_msg=f)
    np.testing.assert_array_equal(n(pfinal.step), np.asarray(jfinal.step))
    np.testing.assert_array_equal(n(pfinal.mppi.wp_idx),
                                  np.asarray(jfinal.mppi.wp_idx))
    assert torch.equal(pfinal.seed, torch.arange(B))
    # the JAX wrapper's own group choice, as the port's picks it
    assert groups == [ploop.auto_group(cp, B)] == [4]


def test_fleet_chained_equals_one_run(ref_path, monkeypatch):
    """PRNG mode: 3 + 2 chained steps equal one 5-step run bitwise, and so
    does the automatic chaining past _FUSED_MAX_STEPS."""
    _, cp = configs(64, 6)
    ref = t(np.asarray(ref_path[:400]), F32)
    s0 = P.init_sim_batch(cp, PSIM, [11, 4, 7, 2], device="cpu")
    _, full = P.simulate_fused_batch(PARM, cp, PSIM, ref, s0, 5)
    s1, r1 = P.simulate_fused_batch(PARM, cp, PSIM, ref, s0, 3)
    s2, r2 = P.simulate_fused_batch(PARM, cp, PSIM, ref, s1, 2)
    monkeypatch.setattr(ploop, "_FUSED_MAX_STEPS", 8)
    s_auto, auto = P.simulate_fused_batch(PARM, cp, PSIM, ref, s0, 5)
    for f, a, b1, b2, c in zip(full._fields, full, r1, r2, auto):
        assert torch.equal(a, torch.cat([b1, b2])), f
        assert torch.equal(a, c), f
    for s in (s2, s_auto):
        assert torch.equal(s.step, torch.full((4,), 5))
        assert torch.equal(s.seed, s0.seed)
        assert torch.equal(s.mppi.u_prev, s_auto.mppi.u_prev)
    # each scenario is its simulate_fused run alone
    one = P.init_sim(cp, PSIM, seed=4, device="cpu")
    _, alone = P.simulate_fused(PARM, cp, PSIM, ref, one, 5)
    for f, a, b in zip(full._fields, full, alone):
        assert torch.equal(a[:, 1], b), f


def test_chunked_run_equals_one_launch_with_frozen_scenarios(ref_path,
                                                             monkeypatch):
    """Chunks past _FUSED_MAX_STEPS fill one record equal to one launch's,
    reference rows included, while odd scenarios sit frozen at the path
    end (their step does not advance)."""
    _, cp = configs(64, 6)
    ref = t(np.asarray(ref_path[:120]), F32)
    B = 4
    q0, up, wp = _fleet_inputs(cp, B, True)
    s0 = P.init_sim_batch(cp, PSIM, [3, 8, 1, 6], q0=q0, device="cpu")
    s0 = s0._replace(step=torch.tensor([0, 2, 5, 1]),
                     mppi=P.MPPIState(u_prev=t(up, F32),
                                      wp_idx=torch.as_tensor(wp)))
    f_one, one = P.simulate_fused_batch(PARM, cp, PSIM, ref, s0, 5)
    monkeypatch.setattr(ploop, "_FUSED_MAX_STEPS", 8)
    f_chunk, chunked = P.simulate_fused_batch(PARM, cp, PSIM, ref, s0, 5)
    assert one.done[:, 1::2].all() and not one.done[:, 0::2].any()
    for f, a, b in zip(one._fields, one, chunked):
        assert torch.equal(a, b), f
    for a, b in ((f_one.q, f_chunk.q), (f_one.dq, f_chunk.dq),
                 (f_one.mppi.u_prev, f_chunk.mppi.u_prev),
                 (f_one.mppi.wp_idx, f_chunk.mppi.wp_idx),
                 (f_one.step, f_chunk.step), (f_one.done, f_chunk.done)):
        assert torch.equal(a, b)
    assert torch.equal(f_chunk.step, torch.tensor([5, 2, 10, 1]))


@pytest.mark.parametrize("K,B,group", [(128, 4096, 8), (128, 12, 4),
                                       (100, 6, 2), (128, 3, 1),
                                       (256, 16, 1)])
def test_auto_group_picks_as_jax_does(ref_path, monkeypatch, K, B, group):
    """The group the JAX wrapper passes to its kernel (recorded at trace
    time; the trace stops there) is the port's ``auto_group``."""
    cj, cp = configs(K, 6)
    seen = []

    class _Stop(Exception):
        pass

    def spy(*a, **k):
        seen.append(k["group"])
        raise _Stop

    monkeypatch.setattr(jps, "pallas_sim_run_batched", spy)
    # an unusual path length keeps the trace out of other tests' jit cache
    ref = jnp.asarray(np.asarray(ref_path[:211], np.float32))
    jstates = J.init_sim_batch(cj, JSIM, jax.vmap(jax.random.PRNGKey)(
        jnp.arange(B)))
    with pytest.raises(_Stop):
        J.simulate_fused_batch(JARM, cj, JSIM, ref, jstates, 3)
    assert seen == [group]
    assert ploop.auto_group(cp, B) == group


def test_group_must_divide_the_batch(ref_path):
    _, cp = configs(32, 6)
    ref = t(np.asarray(ref_path[:100]), F32)
    B = 3
    args = (PARM, cp, PSIM, ref, torch.zeros(B, 2), torch.zeros(B, 2),
            torch.zeros(B, 6, 2), torch.zeros(B, dtype=torch.int64),
            torch.zeros(B, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="divisible"):
        cuda_sim.fused_sim_run_batched(*args, group=2)
    with pytest.raises(ValueError, match="divisible"):
        P.simulate_fused_batch(PARM, cp, PSIM, ref,
                               P.init_sim_batch(cp, PSIM, [0, 1, 2],
                                                device="cpu"), 2, group=2)
