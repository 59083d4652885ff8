"""The per-step solve kernel's plain twin (``ops/cuda_solve.py::
solve_batched_reference``) against the JAX package's ``pallas_solve_batched``
in interpret mode, on the same NumPy noise, plus the twin's own contracts:
tile-size independence, the Philox stream of PRNG mode, and the combine of
one tile, which the kernel does in the tile's own block.

The softmax temperature is raised to lam = 3e5 so that tens of samples
carry weight (at the presets' lam = 1 the costs' spread makes the weights
one-hot and the cross-tile combine would be tested on a single sample).
Tolerances: JAX's eps mode rolls out with the direct trig form and the port
with the trig carry, so S agrees to rtol 2e-5 (measured ~4e-7); Σwε and
u_new to atol 2e-5, the raw (unnormalised) rows to rtol 2e-5 of their
largest magnitude, and (m, η) to rtol 2e-5.  JAX's kernel runs at tile 128
throughout; the port at 128 unless a case names its own tile.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu.ops.pallas_rollout import pallas_solve_batched
from mppi_robotarm_tpu.ops.waypoint import slice_window
from mppi_robotarm_tpu_torch.ops import cuda_solve
from mppi_robotarm_tpu_torch.ops.cuda_rollout import philox_epsilon
from mppi_robotarm_tpu_torch.ops.filters import median_filter_reflect
from _torch_port_helpers import configs, eps_noise, n, t

F32 = torch.float32
LAM = 3e5
RTOL_S = 2e-5
ATOL_W = 2e-5
RTOL_STATS = 2e-5
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.1, -0.2],
              np.float32)


def _inputs(ref_path, B, K, T, seed):
    """Per-scenario states, controls and clamped windows from a seed."""
    rng = np.random.default_rng(seed)
    x0 = (X0 + rng.normal(scale=0.01, size=(B, 4))).astype(np.float32)
    u = (np.asarray(J.MPPIConfig().warm_start, np.float32)
         + rng.normal(size=(B, T, 2))).astype(np.float32)
    ref = jnp.asarray(ref_path, jnp.float32)
    win = np.stack([np.asarray(slice_window(ref, 3 * b, 30)[0])
                    for b in range(B)])
    return x0, u, win, np.full((B,), 30.0, np.float32)


# (B, K, T, cfg overrides, call options; "tile" is the port's, default 128)
CASES = {
    "multi_tile": (1, 300, 8, {}, {}),
    "batch": (3, 256, 6, {}, {}),
    "k_not_lane_multiple": (2, 100, 6, {}, {}),
    "exploration": (1, 300, 5, {"exploration": 0.25}, {}),
    "raw_k_offset": (2, 200, 6, {"exploration": 0.5, "num_samples": 512},
                     {"normalize": False, "k_offset": [0, 150]}),
    "fuse_update": (2, 300, 12, {}, {"fuse_update": True}),
    "u_clamp": (1, 300, 6, {"u_clamp": 12.0}, {}),
    # one tile a scenario: the kernel combines it from its block's shared
    # memory, with the cross-tile expressions
    "one_tile_fuse_update": (3, 100, 12, {}, {"fuse_update": True}),
    "one_tile_raw_k_offset": (2, 128, 8,
                              {"exploration": 0.5, "num_samples": 512},
                              {"normalize": False, "k_offset": [0, 150]}),
    # ten tiles of 32 (the last ragged) against JAX's three of 128
    "tiles_of_32_fuse_update": (2, 300, 12, {},
                                {"fuse_update": True, "tile": 32}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_jax_kernel(ref_path, case):
    B, K, T, over, opts = CASES[case]
    over = dict(over)
    cj, cp = configs(over.pop("num_samples", K), T, lam=LAM, **over)
    x0, u, win, nv = _inputs(ref_path, B, K, T, seed=K + T)
    eps = eps_noise(B + K, (B, K, T, 2))
    k_local = K if K != cp.num_samples else None
    opts = dict(opts)
    tile = opts.pop("tile", 128)
    koff = opts.get("k_offset")
    jopts = dict(opts, k_local=k_local,
                 k_offset=None if koff is None else jnp.asarray(koff))
    w_j, s_j, e_j, (m_j, eta_j) = pallas_solve_batched(
        J.ArmParams(), cj, jnp.asarray(x0), jnp.asarray(u), jnp.asarray(win),
        jnp.asarray(nv), eps=jnp.asarray(eps), interpret=True, tile=128,
        **jopts)
    popts = dict(opts, k_local=k_local,
                 k_offset=None if koff is None else torch.tensor(koff))
    w_p, s_p, e_p, (m_p, eta_p) = cuda_solve.solve_batched(
        P.ArmParams(), cp, t(x0, F32), t(u, F32), t(win, F32), t(nv, F32),
        eps=t(eps, F32), tile=tile, **popts)
    np.testing.assert_array_equal(n(e_p), np.asarray(e_j))
    np.testing.assert_allclose(n(s_p), np.asarray(s_j), rtol=RTOL_S)
    w_j = np.asarray(w_j)
    if opts.get("normalize", True):
        np.testing.assert_allclose(n(w_p), w_j, rtol=0, atol=ATOL_W)
    else:
        np.testing.assert_allclose(n(w_p), w_j, rtol=RTOL_S,
                                   atol=RTOL_S * np.abs(w_j).max())
    np.testing.assert_allclose(n(m_p), np.asarray(m_j), rtol=RTOL_STATS)
    np.testing.assert_allclose(n(eta_p), np.asarray(eta_j), rtol=RTOL_STATS)
    assert float(n(eta_p).min()) > 5.0, "the softmax must spread its weight"


def _solve(cp, x0, u, win, **kw):
    return cuda_solve.solve_batched(P.ArmParams(), cp, t(x0, F32), t(u, F32),
                                    t(win, F32), **kw)


def test_tile_size_does_not_change_the_solve(ref_path):
    """S is per sample and the same bits for any tiling; the combined
    results agree to f32 rounding of the rescaled sums (rtol 2e-6)."""
    _, cp = configs(300, 8, lam=LAM)
    x0, u, win, _ = _inputs(ref_path, 2, 300, 8, seed=1)
    eps = t(eps_noise(3, (2, 300, 8, 2)), F32)
    base = _solve(cp, x0, u, win, eps=eps, tile=512)
    for tile in (32, 128, 160):
        out = _solve(cp, x0, u, win, eps=eps, tile=tile)
        assert torch.equal(out[1], base[1]), tile
        np.testing.assert_allclose(n(out[0]), n(base[0]), rtol=2e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(n(out[3][1]), n(base[3][1]), rtol=2e-6)


@pytest.mark.parametrize("mode", ["raw", "normalize", "fuse_update"])
def test_combine_of_one_tile_is_the_direct_expressions(mode):
    """combine_reference at n_tiles == 1 is, bit for bit, m = m_p, scale =
    exp((m - m_p)/lam), eta = 0 + eta_p·scale and each row 0 + row·scale
    before the output step; so a row of -0 comes out +0, which the
    shortened eta = eta_p, row = row would not give."""
    B, T = 3, 12
    cfg = configs(64, T, lam=LAM)[1]
    rng = np.random.default_rng(7)
    m_p = t(rng.normal(size=(B, 1)) * 100, F32)
    eta_p = t(rng.uniform(1, 50, size=(B, 1)), F32)
    rows = t(rng.normal(size=(B, 1, T, 2)), F32)
    rows[0, 0, 3] = -0.0                    # a row of -0 in both dims
    u = t(rng.normal(size=(B, T, 2)), F32)
    kw = {"raw": dict(normalize=False), "normalize": {},
          "fuse_update": dict(fuse_update=True)}[mode]
    out, m, eta = cuda_solve.combine_reference(m_p, eta_p, rows, u, cfg, **kw)
    scale = torch.exp((m_p[:, 0] - m_p[:, 0]) / cfg.lam)
    want_eta = 0.0 + eta_p[:, 0] * scale
    acc = 0.0 + rows[:, 0] * scale[:, None, None]
    assert torch.equal(m, m_p[:, 0]) and torch.equal(eta, want_eta)
    if mode == "raw":
        assert torch.equal(out, acc)
        assert not torch.signbit(out[0, 3]).any()   # -0 came out +0
        assert torch.signbit(rows[0, 0, 3]).all()
    elif mode == "normalize":
        assert torch.equal(out, acc / want_eta[:, None, None])
    else:
        weps = acc * (1.0 / want_eta)[:, None, None]
        med = median_filter_reflect(weps.transpose(0, 1), cfg.filter_window)
        assert torch.equal(out, u + med.transpose(0, 1))


def test_prng_mode_draws_philox_epsilon(ref_path):
    """PRNG mode on the CPU: the noise is philox_epsilon(seed, step) bit
    for bit, with k_offset selecting rows of the same stream, and the
    results equal eps mode fed that noise."""
    _, cp = configs(512, 6, lam=LAM)
    x0, u, win, _ = _inputs(ref_path, 2, 512, 6, seed=2)
    out = _solve(cp, x0, u, win, seed=torch.tensor([7, 9]),
                 step=torch.tensor([3, 40]), tile=128)
    np.testing.assert_array_equal(n(out[2][0]), n(philox_epsilon(7, 3, cp)))
    np.testing.assert_array_equal(n(out[2][1]), n(philox_epsilon(9, 40, cp)))
    same = _solve(cp, x0, u, win, eps=out[2], tile=128)
    for a, b in zip((out[0], out[1], *out[3]), (same[0], same[1], *same[3])):
        assert torch.equal(a, b)
    shard = _solve(cp, x0, u, win, seed=[7, 9], step=3, k_local=200,
                   k_offset=torch.tensor([100, 312]))
    full = [philox_epsilon(s, 3, cp) for s in (7, 9)]
    np.testing.assert_array_equal(n(shard[2][0]), n(full[0][100:300]))
    np.testing.assert_array_equal(n(shard[2][1]), n(full[1][312:512]))
    none = _solve(cp, x0, u, win, seed=[7, 9], emit_eps=False)
    assert none[2] is None and torch.equal(none[1], _solve(
        cp, x0, u, win, seed=[7, 9], step=0)[1])


def test_cpu_launches_nothing_and_validates(ref_path):
    _, cp = configs(64, 6)
    x0, u, win, _ = _inputs(ref_path, 1, 64, 6, seed=3)
    eps = t(eps_noise(4, (1, 64, 6, 2)), F32)
    before = cuda_solve.LAUNCHES
    w, s, e, (m, eta) = _solve(cp, x0, u, win, eps=eps)
    assert cuda_solve.LAUNCHES == before
    assert w.shape == (1, 6, 2) and s.shape == (1, 64) and e is eps
    assert m.shape == eta.shape == (1,)
    bad = [dict(eps=eps, seed=[1]), dict(), dict(eps=eps, tile=48),
           dict(eps=eps, tile=2048), dict(eps=eps, fuse_update=True,
                                          normalize=False)]
    for kw in bad:
        with pytest.raises(ValueError):
            _solve(cp, x0, u, win, **kw)
    wide = dataclasses.replace(cp, filter_window=13)
    with pytest.raises(ValueError, match="fuse_update"):
        _solve(wide, x0, u, win, eps=eps, fuse_update=True)
    with pytest.raises(TypeError):
        _solve(cp, x0, u, win, seed=torch.tensor([1.5]))
    long = dataclasses.replace(cp, horizon=1000)
    with pytest.raises(ValueError, match="too long"):
        _solve(long, x0, np.zeros((1, 1000, 2), np.float32), win, seed=[1])


def test_solve_core_is_the_single_scenario_shim(ref_path):
    _, cp = configs(200, 6, lam=LAM)
    x0, u, win, nv = _inputs(ref_path, 1, 200, 6, seed=4)
    eps = t(eps_noise(5, (1, 200, 6, 2)), F32)
    w, s, e, _ = _solve(cp, x0, u, win, eps=eps, fuse_update=True)
    w1, s1, e1 = cuda_solve.solve_core(
        P.ArmParams(), cp, t(x0[0], F32), t(u[0], F32), t(win[0], F32),
        float(nv[0]), eps=eps[0], fuse_update=True)
    assert torch.equal(w1, w[0]) and torch.equal(s1, s[0])
    assert torch.equal(e1, e[0])
    _, _, none = cuda_solve.solve_core(
        P.ArmParams(), cp, t(x0[0], F32), t(u[0], F32), t(win[0], F32),
        seed=3, step=5, emit_eps=False)
    assert none is None
