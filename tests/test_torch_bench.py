"""``python -m mppi_robotarm_tpu_torch.bench``, the port of ``bench.py``, on
the CPU at small sizes (the kernels' plain versions):

* the gate statistic, ``utils/metrics.py::onpath_mean_mm``, against NumPy
  transcriptions of ``bench.py:143-150`` (nested in its ``main``) and of
  ``tools/tpu_window_sweep.py::onpath_mm`` (importing that tool enables
  JAX's persistent compile cache and edits ``sys.path``, so it is
  transcribed here), to 1e-12 in float64 on random EE arrays and ``done``
  masks, with fewer and more than 1500 live steps;
* the slice against JAX: 30 steps of the port's ``simulate(backend=
  "eager")`` in float64 against JAX's ``simulate(backend="xla")`` on the
  same ε (JAX's key chain draws it; the port is given it): every record
  field to 1e-9 over the first 20 steps, before the loops part at the
  Lyapunov rate, q and the EE over all 30, and the gate statistic of the
  two runs to 1e-9 mm;
* ``bench_line`` gives exactly bench.py's keys and drops
  ``device_us_per_step`` unless the fused backend won; the backends run in
  bench.py's order, and one that raises propagates; the fit is bench.py's
  two-length arithmetic; the gates raise above 42 mm and 18 mm and below
  1000 live steps; the module run as a program exits non-zero without a
  card, printing nothing on stdout.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu.mppi.solver import sample_epsilon
from mppi_robotarm_tpu.ops.noise import sigma_cholesky
from mppi_robotarm_tpu_torch import bench
from mppi_robotarm_tpu_torch.utils.metrics import onpath_mean_mm
from _torch_port_helpers import configs, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARM, PSIM = P.ArmParams(), P.SimConfig()
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "on_path_mean_mm"}


def bench_py_onpath(ee, done, path_xy):
    """bench.py:143-159's statistic, transcribed."""
    ee = ee[~done][:1500]
    on_path = np.empty(len(ee))
    for i in range(0, len(ee), 256):
        d = np.linalg.norm(ee[i:i + 256, None, :] - path_xy[None], axis=-1)
        on_path[i:i + 256] = d.min(axis=1)
    return float(on_path.mean() * 1e3)


def window_sweep_onpath(ee, done, path_xy, gate_steps=1500):
    """tools/tpu_window_sweep.py::onpath_mm, transcribed."""
    live = ~done
    ee = ee[live][:gate_steps]
    if len(ee) < 100:
        return float("nan")
    out = np.empty(len(ee))
    for i in range(0, len(ee), 256):
        d = np.linalg.norm(ee[i:i + 256, None, :] - path_xy[None], axis=-1)
        out[i:i + 256] = d.min(axis=1)
    return float(out.mean() * 1e3)


@pytest.mark.parametrize("seed, steps, live_share", [
    (0, 4000, 0.9), (1, 1200, 1.0), (2, 2000, 0.5), (3, 700, 0.3),
    (4, 1600, 0.95), (5, 150, 0.5),
])
def test_onpath_statistic_is_bench_pys(seed, steps, live_share):
    rng = np.random.default_rng(seed)
    path_xy = rng.normal(size=(500, 2))
    ee = rng.normal(size=(steps, 2))
    done = rng.random(steps) > live_share
    want = bench_py_onpath(ee, done, path_xy)
    got = onpath_mean_mm(ee, done, path_xy)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    tool = window_sweep_onpath(ee, done, path_xy)
    if (~done).sum() >= 100:          # the tool's floor: NaN below it
        assert got == pytest.approx(tool, rel=1e-12, abs=1e-12)
    else:
        assert np.isnan(tool)
    assert onpath_mean_mm(ee, np.ones(steps, bool), path_xy) != \
        onpath_mean_mm(ee, np.ones(steps, bool), path_xy)   # NaN: none live


def test_the_slice_matches_jax_xla(ref_path):
    """JAX's ``simulate`` draws its noise from its key, so the port's eager
    loop is given the very ε that JAX's key chain draws (``sample_epsilon``
    on each step's subkey, as ``sim_step`` splits it)."""
    steps, K, T = 30, 32, 10
    cj, cp = configs(K, T)
    path = np.asarray(ref_path)
    s0 = J.init_sim(cj, J.SimConfig(), jax.random.PRNGKey(0),
                    dtype=jnp.float64)
    _, jrec = J.simulate(J.ArmParams(), cj, J.SimConfig(), jnp.asarray(path),
                         s0, steps, backend="xla")
    key, eps = s0.key, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        eps.append(np.asarray(sample_epsilon(sub, K, T,
                                             sigma_cholesky(cj.sigma),
                                             jnp.float64)))
    p0 = P.init_sim(cp, PSIM, 0, dtype=torch.float64, device="cpu")
    _, prec = P.simulate(PARM, cp, PSIM, t(path), p0, steps,
                         eps_per_step=t(np.stack(eps)), backend="eager")
    # every field to 1e-9 while the loops agree to rounding; after some 20
    # steps u and the costs part at the loop's Lyapunov rate (1e-6 in u at
    # step 29), while q and the EE stay within 1e-11 over all 30
    for f in P.SimRecord._fields:
        np.testing.assert_allclose(n(getattr(prec, f))[:20],
                                   np.asarray(getattr(jrec, f))[:20],
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    for f in ("q", "ee", "ref_xy", "wp_idx", "done"):
        np.testing.assert_allclose(n(getattr(prec, f)),
                                   np.asarray(getattr(jrec, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    xy = path[:, 0:2]
    ee_j, done_j = np.asarray(jrec.ee), np.asarray(jrec.done)
    mm_p = onpath_mean_mm(n(prec.ee), n(prec.done), xy)
    assert abs(mm_p - bench_py_onpath(ee_j, done_j, xy)) <= 1e-9
    assert abs(onpath_mean_mm(ee_j, done_j, xy)
               - bench_py_onpath(ee_j, done_j, xy)) <= 1e-12
    # the window sweep's onpath_mm has a 100-live-step floor, under which
    # it gives NaN: 30 steps are under it
    assert np.isnan(window_sweep_onpath(ee_j, done_j, xy))
    assert 0 < mm_p < bench.ONPATH_GATE_MM


@pytest.mark.parametrize("best, device_us, ha_mm, extra", [
    ("cuda-fused", 64.219, 7.456, {"device_us_per_step", "high_accuracy_"
                                   "on_path_mean_mm"}),
    ("cuda", 64.219, 7.456, {"high_accuracy_on_path_mean_mm"}),
    ("cuda-fused", None, None, set()),      # --first-only
    ("eager", None, 9.0, {"high_accuracy_on_path_mean_mm"}),
])
def test_bench_line_has_bench_pys_keys(best, device_us, ha_mm, extra):
    line = bench.bench_line(15000.123, 21.2345, best, device_us, ha_mm)
    assert set(line) == BENCH_KEYS | extra
    assert line["metric"] == "mppi_solves_per_s_per_chip_K1024_H50"
    assert line["value"] == 15000.12 and line["unit"] == "solves/s"
    assert line["vs_baseline"] == round(15000.123 * 6.96, 1)
    assert line["on_path_mean_mm"] == 21.23
    if "device_us_per_step" in extra:
        assert line["device_us_per_step"] == 64.22
    assert json.loads(json.dumps(line)) == line
    for bad in (float("nan"), 0.0, float("inf")):
        with pytest.raises(bench.GateError):
            bench.bench_line(bad, 21.0, best)


def _small():
    arm, cfg, sim = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=16, horizon=5)
    ref = torch.as_tensor(P.synth_circle_path(400))
    return arm, cfg, sim, ref, P.init_sim(cfg, sim, seed=0, device="cpu")


def test_backends_run_in_bench_pys_order_and_raise_through(monkeypatch):
    arm, cfg, sim, ref, s0 = _small()
    res = bench.run_backends(arm, cfg, sim, ref, s0, 4, log=io.StringIO())
    assert list(res) == ["cuda-fused", "cuda", "eager"]
    for sps, (final, rec) in res.values():
        assert sps > 0 and rec.q.shape == (4, 2) and int(final.step) == 4
    # the same noise on every backend: the plain versions agree closely
    q = [r[1][1].q for r in res.values()]
    assert torch.allclose(q[0], q[1], atol=1e-5)
    assert torch.allclose(q[0], q[2], atol=1e-5)
    assert bench.best_backend({"a": (1.0, None), "b": (3.0, None)}) == "b"
    first = bench.run_backends(arm, cfg, sim, ref, s0, 2, first_only=True,
                               log=io.StringIO())
    assert list(first) == ["cuda-fused"]

    def broken(*a, **k):
        raise RuntimeError("backend down")

    monkeypatch.setattr(bench, "simulate", broken)
    with pytest.raises(RuntimeError, match="backend down"):
        bench.run_backends(arm, cfg, sim, ref, s0, 2,
                           log=io.StringIO())
    with pytest.raises(ValueError, match="unknown backend"):
        bench.runner("xla", arm, cfg, sim, ref, s0)


def test_device_fit_is_bench_pys_two_length_fit(monkeypatch):
    monkeypatch.setattr(bench, "timed", lambda run, n, device: (0.5, None))
    us, fixed = bench.device_fit(None, 4000, 1.1, torch.device("cpu"))
    assert us == pytest.approx(1e6 * 0.6 / 3000)
    assert fixed == pytest.approx(1.1 - 0.6 / 3000 * 4000)


def _record(ee, done):
    return P.SimRecord(*(torch.as_tensor(ee) if f == "ee"
                         else torch.as_tensor(done) if f == "done" else None
                         for f in P.SimRecord._fields))


@pytest.mark.parametrize("offset_mm, live, gate, raises", [
    (20.0, 2000, 42.0, False),
    (43.0, 2000, 42.0, True),
    (17.0, 1500, 18.0, False),
    (18.5, 1500, 18.0, True),
    (1.0, 999, 42.0, True),          # fewer than 1000 live steps
    (1.0, 1000, 42.0, False),
])
def test_gates_raise(offset_mm, live, gate, raises):
    th = np.linspace(0.0, 2 * np.pi, 3000, endpoint=False)
    path = np.stack([np.cos(th), np.sin(th)], axis=1)
    steps = 2500
    ee = path[:steps] * (1.0 + offset_mm * 1e-3)
    done = np.arange(steps) >= live
    if raises:
        with pytest.raises(bench.GateError):
            bench.gated_onpath_mm(_record(ee, done), path, gate, "case")
    else:
        mm = bench.gated_onpath_mm(_record(ee, done), path, gate, "case")
        assert mm == pytest.approx(offset_mm, rel=1e-6)


def test_the_program_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m",
                           "mppi_robotarm_tpu_torch.bench"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
    proc = subprocess.run([sys.executable, "-m",
                           "mppi_robotarm_tpu_torch.bench", "--steps", "5"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""   # no other flag
