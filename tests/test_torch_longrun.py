"""``tools/longrun.py``: the fused kernel against the per-step loop over a
long horizon, the port of ``tools/tpu_fused_longrun.py``.

On the CPU (the kernels' plain versions):
* the statistics on hand-made schedules and envelopes: the schedule's
  exact prefix and match fraction, the first step over a tolerance, the
  envelope by step, and the report's marks;
* :func:`soak_checks` on hand-made records: live rows, then the state
  frozen at the path's end with zeroed u and cost lanes; a moved frozen
  row, a non-zero u, a NaN, a live row after a frozen one and a wrong step
  counter are each caught;
* the tool's eps-mode run at K = 16, T = 5 for 30 steps (its noise stream
  and path, the fused and the per-step cuda loop) against the JAX
  package's ``simulate_python`` on the same ε: the same waypoint schedule
  at every step, and q within 2e-4 (measured 7.8e-5: the loops agree to
  ulps for some 25 steps, then part at the loop's Lyapunov rate, as
  tests/test_torch_step_tail.py describes for 40 steps);
* a run chained in three parts equals one run, bit for bit, and the tool's
  command line prints the JAX tool's report, on the reference's path (the
  default, as the JAX tool's) and with ``--waypoints 2000`` on the
  synthetic circle;
* the default path is the reference's ``xydq_circle.txt`` in float32, read
  from ``tests/data/reference_golden_run.npz``.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.tools import longrun

try:                                     # the reference of the eps run
    import jax
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    from _torch_port_helpers import configs
except ImportError:
    jax = None

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()


@pytest.mark.parametrize("a, b, prefix, fraction", [
    ([0, 1, 2, 3], [0, 1, 2, 3], 4, 1.0),
    ([0, 1, 2, 3], [0, 1, 5, 3], 2, 0.75),
    ([4, 1, 2, 3], [0, 1, 2, 3], 0, 0.75),
    ([0, 0, 1, 1, 2], [0, 0, 1, 2, 2], 3, 0.8),
])
def test_schedule_agreement(a, b, prefix, fraction):
    assert longrun.schedule_agreement(a, b) == (prefix, pytest.approx(
        fraction))


def test_first_above_and_the_envelope():
    d = np.array([0.0, 1e-7, 5e-6, 2e-4, 3e-3, 1e-5])
    assert longrun.first_above(d, 1e-6) == 2
    assert longrun.first_above(d, 1e-3) == 4
    assert longrun.first_above(d, 1.0) == len(d)
    rec = _record(6, 6)._replace(q=torch.zeros(6, 2), u=torch.zeros(6, 2))
    dq = torch.tensor(d, dtype=torch.float32)
    other = rec._replace(q=torch.stack([-dq / 2, dq], dim=-1),
                         u=torch.stack([torch.zeros(6), -2.0 * torch.arange(
                             6.0)], dim=-1))
    qd, ud = longrun.envelope(rec, other)
    np.testing.assert_array_equal(qd, dq.double().numpy())
    np.testing.assert_array_equal(ud, 2.0 * np.arange(6))


def _record(steps, live, dtype=torch.float32):
    """A hand-made record of ``steps`` steps, ``live`` of them live: the
    EE on a unit circle around (0.8, 0.8), then the last live row frozen
    with u and the cost lanes zeroed."""
    k = torch.arange(steps, dtype=dtype)
    th = 0.01 * torch.minimum(k, torch.tensor(live - 1, dtype=dtype))
    done = k >= live
    rows = lambda *v: torch.stack(v, dim=-1)
    zero = lambda v: torch.where(done, torch.zeros_like(v), v)
    q = rows(th, -th)
    ee = rows(0.8 + 0.6 * torch.cos(th), 0.8 + 0.6 * torch.sin(th))
    return P.SimRecord(
        q=q, dq=rows(th * 2, th * 3), u=rows(zero(1 + k), zero(2 + k)),
        ee=ee, elbow=ee / 2, ref_xy=ee, wp_idx=torch.minimum(
            k.long(), torch.tensor(live - 1)),
        cost_min=zero(1 + k), cost_mean=zero(2 + k), ess=zero(3 + k),
        weight_entropy=zero(4 + k), done=done)


def _final(rec, live):
    return P.init_sim(P.MPPIConfig(), SIM, device="cpu")._replace(
        step=torch.tensor(live), q=rec.q[-1], done=rec.done[-1])


def test_soak_checks_on_hand_made_records():
    th = 0.01 * np.arange(50)          # the path through the EE's points
    path = np.stack([0.8 + 0.6 * np.cos(th), 0.8 + 0.6 * np.sin(th)], axis=1)
    rec = _record(50, 30)
    c = longrun.soak_checks(_final(rec, 30), rec, path)
    assert c["finite"] and c["frozen"] and c["counter"] and c["reached_end"]
    assert c["live_steps"] == 30 and c["end_step"] == 30
    assert c["onpath_mean_mm"] < 1e-3
    moved = rec._replace(ee=rec.ee + torch.tensor([0.0, 0.002]))
    assert longrun.soak_checks(_final(moved, 30), moved, path)[
        "onpath_mean_mm"] == pytest.approx(2.0, abs=0.1)
    # a run that never reaches the end: nothing frozen, nothing to check
    alive = _record(20, 20)
    c = longrun.soak_checks(_final(alive, 20), alive, path)
    assert c["frozen"] and not c["reached_end"] and c["end_step"] is None
    q = rec.q.clone()
    q[40, 1] += 1e-6
    u = rec.u.clone()
    u[35, 0] = 1e-9
    ess = rec.ess.clone()
    ess[45] = float("nan")
    done = rec.done.clone()
    done[40] = False
    for bad, field in ((rec._replace(q=q), "frozen"),
                       (rec._replace(u=u), "frozen"),
                       (rec._replace(ess=ess), "finite"),
                       (rec._replace(done=done), "frozen")):
        assert not longrun.soak_checks(_final(bad, 30), bad, path)[field]
    assert not longrun.soak_checks(_final(rec, 29), rec, path)["counter"]


def test_the_eps_run_matches_jax_simulate_python():
    if jax is None:
        pytest.skip("needs the JAX package")
    steps = 30
    cj, cp = configs(16, 5)
    path = P.synth_circle_path(2000)
    eps = longrun.eps_stream(steps, cp)
    assert eps.dtype == np.float32 and eps.shape == (steps, 16, 5, 2)
    ref, eps_t = torch.as_tensor(path), torch.as_tensor(eps)
    s0 = J.init_sim(cj, J.SimConfig(), jax.random.PRNGKey(0),
                    dtype=jnp.float32)
    _, recs = J.simulate_python(J.ArmParams(), cj, J.SimConfig(),
                                jnp.asarray(path), s0, steps,
                                eps_per_step=[jnp.asarray(e) for e in eps])
    q_j = np.array([r[0] for r in recs])
    wp_j = np.array([r[3] for r in recs])
    runs = (longrun.run_fused(ARM, cp, SIM, ref, steps, eps_t),
            longrun.run_per_step(ARM, cp, SIM, ref, steps, eps_t))
    for _, rec, _ in runs:
        np.testing.assert_array_equal(rec.wp_idx.numpy(), wp_j)
        np.testing.assert_allclose(rec.q.numpy(), q_j, rtol=0, atol=2e-4)
    rep = longrun.compare(runs[0][1], runs[1][1], path[:, 0:2])
    assert rep["wp_prefix"] == steps and rep["wp_match_fraction"] == 1.0
    assert sorted(rep["envelope"]) == [0, 9, 24, steps - 1]


def test_a_chained_run_equals_one_run():
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=16, horizon=5)
    ref = torch.as_tensor(P.synth_circle_path(200))
    one_fin, one, _ = longrun.run_fused(ARM, cfg, SIM, ref, 12)
    fin, parts, _ = longrun.run_fused(ARM, cfg, SIM, ref, 12, chunks=3)
    for a, b in zip(one, parts):
        assert torch.equal(a, b)
    assert torch.equal(fin.q, one_fin.q) and int(fin.step) == 12


@pytest.mark.parametrize("path_args, path_text", [
    ([], "path the reference's xydq_circle.txt, 2000 points"),
    (["--waypoints", "2000"],
     "path synth_circle_path(2000), 1 revolutions, 2000 points"),
])
def test_the_command_line_prints_the_report(path_args, path_text):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert longrun.main(["12", "--device", "cpu", *path_args]) == 0
    out = buf.getvalue()
    for text in (path_text, "steps=12  K=100 T=30", "noise injected",
                 "wp schedule: "
                 "exact prefix", "|dq|: <1e-6 for", "on-path EE mean: fused",
                 "step-aligned RMS: fused", "step     9:", "step    11:",
                 "fused: {'finite': True"):
        assert text in out, out


def test_the_default_path_is_the_references():
    with np.load(P.sim.paths.REFERENCE_RUN) as run:
        want = run["ref_path"].astype(np.float32)
    path = longrun.problem(3)[3]
    assert path.dtype == np.float32
    np.testing.assert_array_equal(path, want)
    np.testing.assert_array_equal(longrun.problem(3, waypoints=2000)[3],
                                  P.synth_circle_path(2000))


def test_the_first_on_path_window_is_bench_pys():
    """``onpath_first_mm`` averages the first ONPATH_FIRST live steps only,
    as bench.py's gate does; ``onpath_mean_mm`` all of them."""
    n = longrun.ONPATH_FIRST + 500
    rec = _record(n, n)
    th = 0.01 * np.arange(n)
    path = np.stack([0.8 + 0.6 * np.cos(th), 0.8 + 0.6 * np.sin(th)], axis=1)
    # 10 mm off the circle, radially, after the window
    grow = torch.ones(n, 1)
    grow[longrun.ONPATH_FIRST:] = 1.0 + 0.01 / 0.6
    ee = 0.8 + (rec.ee - 0.8) * grow
    c = longrun.soak_checks(_final(rec, n), rec._replace(ee=ee), path)
    assert c["onpath_first_mm"] < 0.01
    assert c["onpath_mean_mm"] == pytest.approx(10.0 * 500 / n, rel=0.05)


def test_the_new_modules_never_import_jax():
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import mppi_robotarm_tpu_torch.tools.longrun\n"
            "import mppi_robotarm_tpu_torch.ops.cuda_pathgen\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m == 'mppi_robotarm_tpu' or "
            "m.startswith('mppi_robotarm_tpu.') for m in sys.modules)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
