"""The port's eager ops and kernel helpers against scipy, JAX and known
answers."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import median_filter

import mppi_robotarm_tpu.ops.filters as jfilt
import mppi_robotarm_tpu.ops.rollout as jroll
import mppi_robotarm_tpu.ops.waypoint as jwp
import mppi_robotarm_tpu.ops.weights as jw
from mppi_robotarm_tpu.config import ArmParams as JArm
from mppi_robotarm_tpu.ops import pallas_rollout as jpr
import mppi_robotarm_tpu_torch.ops.filters as pfilt
import mppi_robotarm_tpu_torch.ops.rollout as proll
import mppi_robotarm_tpu_torch.ops.waypoint as pwp
import mppi_robotarm_tpu_torch.ops.weights as pw
from mppi_robotarm_tpu_torch.config import ArmParams as PArm
from mppi_robotarm_tpu_torch.ops import cuda_rollout as pcr
from mppi_robotarm_tpu_torch.ops import noise as pnoise
from _torch_port_helpers import configs, eps_noise, n, t

# the cases of tests/test_filters.py inside the scipy parity domain size<=2T
MEDIAN_CASES = [(tt, s) for tt in (5, 10, 30, 50)
                for s in (1, 2, 3, 4, 5, 9, 10, 11, 12) if s <= 2 * tt]


@pytest.mark.parametrize("t_len,size", MEDIAN_CASES)
def test_median_bitwise_scipy_and_jax(t_len, size):
    x = np.random.default_rng(t_len * 100 + size).normal(size=(t_len, 2))
    got = n(pfilt.median_filter_reflect(t(x), size))
    exp = np.stack([median_filter(x[:, d], size=size, mode="reflect")
                    for d in range(2)], axis=1)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(
        got, np.asarray(jfilt.median_filter_reflect(jnp.asarray(x), size)))


def test_median_rejects_size_zero():
    with pytest.raises(ValueError):
        pfilt.median_filter_reflect(torch.zeros(4, 2), 0)


def _path(npts=60, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.0, 1.0, size=(npts, 4))
    p[10] = p[11]            # a duplicated row: a guaranteed tie
    return p


@pytest.mark.parametrize("start", [0, 5, 40, 59])
def test_waypoint_window_ties_and_truncation_match_jax(start):
    path = _path()
    W = 30
    wj, vj = jwp.slice_window(jnp.asarray(path), start, W)
    wp, vp = pwp.slice_window(t(path), torch.tensor(start), W)
    np.testing.assert_array_equal(n(wp), np.asarray(wj))
    np.testing.assert_array_equal(n(vp), np.asarray(vj))
    # query points ON waypoints (exact ties with the duplicate) and off them
    rng = np.random.default_rng(start)
    x = np.concatenate([path[[10, 11, 12, 59], 0], rng.uniform(-1, 1, 64)])
    y = np.concatenate([path[[10, 11, 12, 59], 1], rng.uniform(-1, 1, 64)])
    outj = jwp.nearest_in_window(jnp.asarray(x), jnp.asarray(y), wj, vj,
                                 100.0)
    outp = pwp.nearest_in_window(t(x), t(y), wp, vp, 100.0)
    for a, b in zip(outp, outj):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    for xi, yi in zip(x[:6], y[:6]):
        ij, winj, validj = jwp.update_waypoint_index(
            jnp.asarray(path), start, xi, yi, W, 100.0)
        ip, winp, validp = pwp.update_waypoint_index(
            t(path), torch.tensor(start), t(xi), t(yi), W, 100.0)
        assert int(ip) == int(ij)
        np.testing.assert_array_equal(n(winp), np.asarray(winj))
        np.testing.assert_array_equal(n(validp), np.asarray(validj))


def test_weights_match_jax():
    s = np.random.default_rng(5).uniform(1e3, 1e5, size=(3, 257))
    s[1, :] = s[1, 0]                    # all equal: uniform weights
    wj = jw.mppi_weights(jnp.asarray(s), 100.0)
    wp = pw.mppi_weights(t(s), 100.0)
    # atol: the two differ only below the smallest normal double
    np.testing.assert_allclose(n(wp), np.asarray(wj), rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(n(pw.effective_sample_size(wp)),
                               np.asarray(jw.effective_sample_size(wj)),
                               rtol=1e-12)
    np.testing.assert_allclose(n(pw.weight_entropy(wp)),
                               np.asarray(jw.weight_entropy(wj)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k_offset,exploration,clamp",
                         [(0, 0.0, None), (40, 0.3, None), (0, 0.0, 12.0)])
def test_rollout_costs_match_jax(ref_path, k_offset, exploration, clamp):
    cj, cp = configs(64, 12, exploration=exploration, u_clamp=clamp)
    rng = np.random.default_rng(11)
    x0 = np.array([1.15, -1.27, 0.3, -0.2])
    u = rng.normal(size=(12, 2)) * 5 + np.array([10.0, -2.0])
    eps = eps_noise(12, (64, 12, 2), np.float64)
    path = np.asarray(ref_path)
    win_j, val_j = jwp.slice_window(jnp.asarray(path), 3, 30)
    sinv = np.linalg.inv(np.asarray(cj.sigma))
    sj, xj = jroll.rollout_costs(JArm(), cj, jnp.asarray(x0), jnp.asarray(u),
                                 jnp.asarray(eps), win_j, val_j,
                                 jnp.asarray(sinv), k_offset=k_offset)
    win_p, val_p = pwp.slice_window(t(path), 3, 30)
    sp, xp = proll.rollout_costs(PArm(), cp, t(x0), t(u), t(eps), win_p,
                                 val_p, t(sinv), k_offset=k_offset)
    np.testing.assert_allclose(n(sp), np.asarray(sj), rtol=1e-12)
    np.testing.assert_allclose(n(xp), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tracking_cost_matches_pallas_helper(ref_path, dtype):
    """The kernel's exact-metric, unmasked cost against the Pallas helper it
    ports (called on plain arrays), ties and a clamped window included."""
    cj, cp = configs(64, 8)
    td = torch.float64 if dtype == np.float64 else torch.float32
    path = np.asarray(ref_path)[-40:].astype(dtype)
    path[5] = path[6]
    win_j, _ = jwp.slice_window(jnp.asarray(path), 25, 30)   # clamped tail
    rng = np.random.default_rng(2)
    x = np.concatenate([path[[5, 6, 39], 0],
                        path[:, 0].mean() + rng.normal(size=61) * 0.01])
    y = np.concatenate([path[[5, 6, 39], 1],
                        path[:, 1].mean() + rng.normal(size=61) * 0.01])
    dq1, dq2 = (rng.normal(size=64) for _ in range(2))
    x, y, dq1, dq2 = (a.astype(dtype) for a in (x, y, dq1, dq2))
    exp = jpr._tracking_cost(None, None, jnp.asarray(dq1), jnp.asarray(dq2),
                             win_j, 30.0, *cj.stage_cost_weight, cfg=cj,
                             window_len=30, unroll=True,
                             xy=(jnp.asarray(x), jnp.asarray(y)))
    win_p, _ = pwp.slice_window(t(path, td), 25, 30)
    got = pcr.tracking_cost(t(x, td), t(y, td), t(dq1, td), t(dq2, td),
                            win_p, cp.stage_cost_weight, cp)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(n(got), np.asarray(exp), rtol=rtol)


PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,expected", PHILOX_KAT)
def test_philox_known_answers(ctr, key, expected):
    """Random123's known-answer vectors for philox4x32-10."""
    out = pcr.philox4x32_10(
        tuple(torch.tensor(c, dtype=torch.int64) for c in ctr), key)
    assert tuple(int(o) for o in out) == expected


def test_uniform_from_bits_range():
    bits = torch.tensor([0, 255, 256, 0xFFFFFF00, 0xFFFFFFFF])
    u = pcr.uniform_from_bits(bits)
    assert u.dtype == torch.float32
    assert float(u[0]) == 2.0 ** -25 and float(u[1]) == 2.0 ** -25
    assert float(u[2]) == 2.0 ** -24 + 2.0 ** -25
    assert float(u[-1]) == 1.0            # top bin rounds to 1.0
    assert bool((u > 0).all()) and bool((u <= 1).all())


def test_box_muller_moments():
    """10^6 draws of the fused loop's noise: mean within 0.02·σ, variance
    within 2 % of Σ, and counter streams that differ per (seed, step)."""
    _, cfg = configs(20000, 50)
    sigma = np.asarray(cfg.sigma)
    eps = n(pcr.philox_epsilon(123, 7, cfg)).reshape(-1, 2).astype(np.float64)
    assert eps.shape == (10 ** 6, 2) and np.isfinite(eps).all()
    sd = np.sqrt(np.diag(sigma))
    assert (np.abs(eps.mean(axis=0)) < 0.02 * sd).all()
    cov = np.cov(eps.T)
    assert (np.abs(np.diag(cov) / np.diag(sigma) - 1.0) < 0.02).all()
    assert abs(cov[0, 1]) < 0.02 * sd.prod()
    small = dataclasses.replace(cfg, num_samples=64, horizon=8)
    a = pcr.philox_epsilon(1, 0, small)
    assert torch.equal(a, pcr.philox_epsilon(1, 0, small))
    assert not torch.equal(a, pcr.philox_epsilon(1, 1, small))
    assert not torch.equal(a, pcr.philox_epsilon(2, 0, small))


def test_sample_epsilon_uses_its_generator():
    chol = pnoise.sigma_cholesky(((20.0, 0.0), (0.0, 20.0)))
    a = pnoise.sample_epsilon(torch.Generator().manual_seed(4), 5000, 10,
                              chol)
    b = pnoise.sample_epsilon(torch.Generator().manual_seed(4), 5000, 10,
                              chol)
    assert a.shape == (5000, 10, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert abs(float(a.var()) / 20.0 - 1.0) < 0.05
    np.testing.assert_allclose(pnoise.sigma_inverse([[20.0, 0.0],
                                                     [0.0, 20.0]]),
                               np.eye(2) / 20.0)
