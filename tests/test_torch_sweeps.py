"""The gate sweeps and the stress shapes of the port, on the CPU:

* ``tools/bench_gate_sweep.py`` (the port of
  ``tools/tpu_bench_gate_sweep.py``) over 2 seeds at a tiny size prints a
  line a seed, the spread and the suggested gate; its spread lines count
  the seeds over a gate; without a card its command line exits non-zero;
* ``tools/seed_sweep.py`` (the port of ``tools/tpu_seed_sweep.py``) runs
  each of its three loops over 2 seeds at a tiny size and prints its
  closing lines; its path is the reference's ``xydq_circle.txt`` as
  ``tests/data/reference_golden_run.npz`` keeps it, bit for bit (float32 as
  the JAX tool loads it), and it raises when that file is missing, as does
  ``tools/longrun.py``;
* ``tools/extreme_shapes.py`` (the port of ``tools/tpu_extreme_shapes.py``):
  at each of its five shapes the layout an H100 (132 SMs) gets is a tile
  that is a multiple of 32 within ``_max_tile``, enough tiles to cover K,
  at most 512 threads a block and the shared memory the tool printed on
  the card, within a block's limit;
  its tool's helpers run one solve on the CPU; and one long-horizon solve
  (K = 64, T = 500, injected ε) of the solve kernel's plain version equals
  JAX ``solve(backend="xla")`` to 1e-9 in float64.
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.sim import paths
from mppi_robotarm_tpu_torch.tools import (bench_gate_sweep, extreme_shapes,
                                           longrun, seed_sweep)
from mppi_robotarm_tpu_torch.utils import roofline
from _torch_port_helpers import configs, eps_noise, n, t

H100_SMS = 132


def _lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_bench_gate_sweep_prints_a_line_a_seed_and_the_spread():
    arm, cfg, sim = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=16, horizon=5)
    path = P.synth_circle_path(400)
    buf = io.StringIO()
    errs = bench_gate_sweep.sweep(arm, cfg, sim, path, 6, range(2),
                                  torch.device("cpu"), out=buf)
    out = buf.getvalue().splitlines()
    assert len(errs) == 2 and all(np.isfinite(errs))
    assert out[0].startswith("  seed 0: on-path mean")
    assert out[1].startswith("  seed 1: on-path mean")
    assert "final-wp" in out[0]
    lines = bench_gate_sweep.spread_lines(errs, 42.0)
    assert lines[0].startswith("spread over 2 seeds: min ")
    assert lines[1].startswith("suggested gate (max + 30% margin): ")
    assert lines[2] == "gate 42 mm: 0 of 2 seeds over it"


def test_spread_lines_count_the_seeds_over_the_gate():
    lines = bench_gate_sweep.spread_lines([8.4, 31.7, 21.0, 19.7], 18.0,
                                          "[x] ")
    assert lines == [
        "[x] spread over 4 seeds: min 8.4 / mean 20.2 / max 31.7 mm",
        "[x] suggested gate (max + 30% margin): 42 mm",
        "[x] gate 18 mm: 3 of 4 seeds over it (seeds [1, 2, 3])"]


def test_the_sweeps_exit_non_zero_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_gate_sweep.main(["2", "high_accuracy"]) == 1
    assert seed_sweep.main(["2", "5", "cuda"]) == 1


@pytest.mark.parametrize("mode", seed_sweep.MODES)
def test_seed_sweep_runs_each_loop(mode):
    rc, out = _lines(seed_sweep.main, ["2", "5", mode, "16", "--device",
                                       "cpu"])
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].endswith(f"seeds=2 steps=5 mode={mode} K=16")
    assert lines[1].startswith("  seed 0: on-path mean")
    assert "step-aligned RMS" in lines[1] and "final wp" in lines[1]
    assert lines[3].startswith(f"[{mode}] on-path mean over seeds: ")
    assert "reference's own executed run: 10.76 mm" in lines[3]
    assert lines[4].startswith(f"[{mode}] spread over 2 seeds: ")
    assert lines[5].startswith(f"[{mode}] suggested gate (max + 30% margin)")
    # the JAX package's bound for this configuration, not bench.py's 42 mm
    assert lines[6].startswith(f"[{mode}] gate 45 mm: ")


def test_seed_sweep_runs_on_the_references_path():
    with np.load(paths.REFERENCE_RUN) as run:
        want = run["ref_path"]
    got = paths.reference_circle_path()
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    assert seed_sweep.reference_path().tobytes() == \
        want.astype(np.float32).tobytes()


def test_a_missing_reference_path_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(paths, "REFERENCE_RUN", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="none.npz"):
        paths.reference_circle_path()
    with pytest.raises(FileNotFoundError):
        seed_sweep.main(["2", "5", "eager", "16", "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        longrun.problem(3)
    longrun.problem(3, waypoints=200)         # a synthetic path needs none


# (K, T, tile, tiles, lanes, group, shared memory bytes): the layouts an
# H100 gets, as tools/extreme_shapes.py prints them on the card (PERF.md)
STRESS = [(65536, 50, 512, 128, 1, 1, 208200),
          (65536, 200, 128, 512, 1, 1, 209064),
          (8192, 500, 32, 256, 2, 1, 136680),
          (131072, 100, 256, 512, 1, 1, 207976),
          (1024, 30, 32, 32, 4, 1, 8968)]


@pytest.mark.parametrize("K, T, tile, tiles, lanes, group, smem", STRESS)
def test_stress_shape_layouts_fit_a_block(K, T, tile, tiles, lanes, group,
                                          smem):
    assert (K, T) in extreme_shapes.SHAPES
    cfg = extreme_shapes.shape_config(K, T)
    assert cuda_solve.solve_layout(cfg, K, 1, sm_count=H100_SMS) == (
        tile, lanes, group)
    assert cuda_solve._plan(cfg, K, None, True, True, 1, H100_SMS) == (
        tile, tiles, lanes, group)
    assert tile % 32 == 0 and 32 <= tile <= cuda_solve._max_tile(cfg)
    assert tiles * tile >= K > (tiles - 1) * tile
    assert group * lanes * tile <= cuda_solve.MAX_THREADS
    assert cuda_solve.solve_smem_bytes(cfg, tile, tiles, group) == smem
    assert smem <= cuda_solve.SMEM_BYTES


def test_extreme_shapes_helpers_on_the_cpu():
    arm = P.ArmParams()
    cfg = extreme_shapes.shape_config(64, 12)
    ref, x0, state = extreme_shapes.inputs(cfg, torch.device("cpu"))
    assert ref.shape == (extreme_shapes.PATH_POINTS, 4)
    assert extreme_shapes.layout(cfg, torch.device("cpu"))["tiles"] == 1
    launches, finite = extreme_shapes.solve_once(arm, cfg, ref, x0, state)
    assert finite and launches == 0      # CPU tensors launch no kernel
    rng = np.random.default_rng(0)
    for noise in ("eps", "prng"):
        d = extreme_shapes.hold_to_plain(arm, cfg, ref, x0, state, noise, rng)
        assert d == {"du": 0.0, "deta": 0.0}
    ms, by = roofline.solve_bound(cfg, 1)
    assert by == "operations" and ms == pytest.approx(
        roofline.solve_ops(cfg, 1) / roofline.PEAK_OPS * 1e3)


def test_long_horizon_solve_matches_jax_xla(ref_path):
    K, T = 64, 500
    cj, cp = configs(K, T, lam=3e5)
    path = np.asarray(ref_path)
    x0 = np.array(extreme_shapes.X0)
    u = np.tile(np.array(cp.warm_start), (T, 1))
    eps = eps_noise(5, (K, T, 2), np.float64)
    rj = J.solve(J.ArmParams(), cj, jnp.asarray(path), jnp.asarray(x0),
                 J.MPPIState(jnp.asarray(u), jnp.asarray(0, jnp.int32)),
                 eps=jnp.asarray(eps), backend="xla")
    _, wp, _, win = cuda_step.step_head_plain(
        cp, t(path), t(x0[None, 0:2]), t(x0[None, 2:4]), torch.tensor([0]))
    assert int(wp[0]) == int(rj.state.wp_idx)
    tile, tiles = cuda_solve._plan(cp, K, None, True, True)[:2]
    assert (tile, tiles) == (32, 2)          # the smallest tile, two of them
    out, s, _, _ = cuda_solve.solve_batched_reference(
        P.ArmParams(), cp, t(x0[None]), t(u[None]), win, eps=t(eps[None]),
        fuse_update=True)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(n(s[0]), np.asarray(rj.costs), rtol=1e-9)
    np.testing.assert_allclose(n(out[0]), np.asarray(rj.u_seq), rtol=1e-9,
                               atol=1e-9)
