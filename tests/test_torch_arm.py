"""The port's arm model against the JAX package and the NumPy oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

import mppi_robotarm_tpu.models.arm as jarm
import mppi_robotarm_tpu.sim.paths as jpaths
from mppi_robotarm_tpu.config import ArmParams as JArm
from mppi_robotarm_tpu.ops import pallas_rollout as jpr
import mppi_robotarm_tpu_torch.models.arm as parm
import mppi_robotarm_tpu_torch.sim.paths as ppaths
from mppi_robotarm_tpu_torch.config import ArmParams as PArm
from mppi_robotarm_tpu_torch.ops import cuda_rollout as pcr
from oracle import oracle_ddq, oracle_step
from _torch_port_helpers import n, t

JA, PA = JArm(), PArm()
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-6, atol=1e-6)}


def _states(dtype, size=257, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-np.pi, np.pi, size=(2, size))
    dq = rng.normal(size=(2, size)) * 3.0
    u = rng.normal(size=(2, size)) * 20.0
    return [a.astype(dtype) for a in (*q, *dq, *u)]


def _both(dtype, fn_j, fn_p, args):
    tdtype = {np.float64: "float64", np.float32: "float32"}[dtype]
    import torch
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    out_p = fn_p(*(t(a, getattr(torch, tdtype)) for a in args))
    for a, b in zip(out_j, out_p):
        np.testing.assert_allclose(n(b), n(a), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mass_gravity_ddq_step_match_jax(dtype):
    q1, q2, dq1, dq2, u1, u2 = _states(dtype)
    _both(dtype, lambda a: jarm.mass_matrix(a, JA),
          lambda a: parm.mass_matrix(a, PA), (q2,))
    _both(dtype, lambda a, b: jarm.gravity_vector(a, b, JA),
          lambda a, b: parm.gravity_vector(a, b, PA), (q1, q2))
    _both(dtype, lambda *a: jarm.arm_ddq(*a, JA),
          lambda *a: parm.arm_ddq(*a, PA), (q1, q2, dq1, dq2, u1, u2))
    _both(dtype, lambda *a: jarm.arm_step(*a, 0.006, JA),
          lambda *a: parm.arm_step(*a, 0.006, PA), (q1, q2, dq1, dq2, u1, u2))
    _both(dtype, lambda a, b: jarm.fk_ee(a, b, 1.0, 1.0),
          lambda a, b: parm.fk_ee(a, b, 1.0, 1.0), (q1, q2))
    _both(dtype, lambda a, b: jarm.fk_full(a, b, JA),
          lambda a, b: parm.fk_full(a, b, PA), (q1, q2))


def test_ddq_and_step_match_oracle():
    q1, q2, dq1, dq2, u1, u2 = _states(np.float64)
    got = parm.arm_ddq(*(t(a) for a in (q1, q2, dq1, dq2, u1, u2)), PA)
    exp = oracle_ddq(q1, q2, dq1, dq2, u1, u2)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(n(a), b, rtol=1e-12, atol=1e-12)
    x = np.stack([q1, q2, dq1, dq2], axis=-1)
    u = np.stack([u1, u2], axis=-1)
    got = parm.arm_step(*(t(a) for a in (q1, q2, dq1, dq2, u1, u2)), 0.006,
                        PA)
    np.testing.assert_allclose(np.stack([n(v) for v in got], axis=-1),
                               oracle_step(x, u, 0.006), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_dynamics_helpers_match_jax(dtype):
    """The fused kernel's trig-supplied step (cuda_rollout) against the
    Pallas helper it ports, and against arm_step."""
    import torch
    td = torch.float64 if dtype == np.float64 else torch.float32
    q1, q2, dq1, dq2, u1, u2 = _states(dtype)
    trig = (np.cos(q1), np.cos(q2), np.sin(q2), np.cos(q1 + q2))
    trig = [a.astype(dtype) for a in trig]
    exp = jpr._dynamics_step_trig(
        *(jnp.asarray(a) for a in (q1, q2, dq1, dq2, u1, u2)), 0.006, JA,
        *(jnp.asarray(a) for a in trig))
    got = pcr.dynamics_step_trig(
        *(t(a, td) for a in (q1, q2, dq1, dq2, u1, u2)), 0.006, PA,
        *(t(a, td) for a in trig))
    for a, b in zip(got, exp):
        np.testing.assert_allclose(n(a), n(b), **TOL[dtype])
    got = pcr.dynamics_step(*(t(a, td) for a in (q1, q2, dq1, dq2, u1, u2)),
                            0.003, PA)
    exp = parm.arm_step(*(t(a, td) for a in (q1, q2, dq1, dq2, u1, u2)),
                        0.003, PA)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(n(a), n(b), **TOL[dtype])


@pytest.mark.parametrize("overrides", [True, False])
def test_ik_circle_matches_jax(overrides):
    # θ crosses both closure-override bands around 2π
    theta = np.concatenate([np.linspace(0.0, 2 * np.pi + 0.5, 401),
                            [2 * np.pi - 0.2, 2 * np.pi + 0.2]])
    rj, xj, yj = jarm.ik_circle(jnp.asarray(theta),
                                closure_overrides=overrides)
    rp, xp, yp = parm.ik_circle(t(theta), closure_overrides=overrides)
    for a, b in ((rp, rj), (xp, xj), (yp, yj)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-12, atol=1e-12,
                                   equal_nan=True)


@pytest.mark.parametrize("npts,revs", [(2000, 1.0), (8000, 1.0), (40, 0.02),
                                       (500, 2.0)])
def test_synth_circle_path_matches_jax(npts, revs):
    exp = jpaths.synth_circle_path(npts, revolutions=revs, dtype=np.float64)
    got = ppaths.synth_circle_path(npts, revolutions=revs, dtype=np.float64)
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-9)
    got32 = ppaths.synth_circle_path(npts, revolutions=revs)
    assert got32.dtype == np.float32 and got32.shape == (npts, 4)
    np.testing.assert_allclose(got32, exp, rtol=1e-6, atol=1e-4)


def test_load_ref_path(tmp_path):
    path = ppaths.synth_circle_path(50, dtype=np.float64)
    six = np.concatenate([path, np.zeros((50, 2))], axis=1)
    f = tmp_path / "p.txt"
    np.savetxt(f, six)
    np.testing.assert_array_equal(ppaths.load_ref_path(str(f)),
                                  jpaths.load_ref_path(str(f)))
    np.savetxt(f, np.zeros((5, 3)))
    with pytest.raises(ValueError):
        ppaths.load_ref_path(str(f))
