"""The port's utilities against the JAX package's: checkpoints both ways
and resume, solver metrics and their logger, timing, plotting, the joint-log
path loaders and the visualisation re-rollouts."""

import io
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mppi_robotarm_tpu as J
import mppi_robotarm_tpu.sim.paths as jpaths
import mppi_robotarm_tpu.utils.checkpoint as jck
import mppi_robotarm_tpu.utils.metrics as jmet
import mppi_robotarm_tpu.utils.plotting as jplot
import mppi_robotarm_tpu_torch as P
import mppi_robotarm_tpu_torch.sim.paths as ppaths
import mppi_robotarm_tpu_torch.utils.checkpoint as pck
import mppi_robotarm_tpu_torch.utils.metrics as pmet
import mppi_robotarm_tpu_torch.utils.plotting as pplot
import mppi_robotarm_tpu_torch.utils.timing as ptime
from mppi_robotarm_tpu_torch import convert
from mppi_robotarm_tpu_torch.mppi.solver import viz_rollouts
from _torch_port_helpers import configs, eps_noise, n, t

JARM, JSIM = J.ArmParams(), J.SimConfig()
PARM, PSIM = P.ArmParams(), P.SimConfig()
F32 = torch.float32


def _npz(path) -> dict:
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


# ---- checkpoints ------------------------------------------------------------

def test_checkpoint_resume_continues_the_fused_loop_bitwise(ref_path,
                                                            tmp_path):
    """6 steps of simulate_fused (CPU twin) equal 3, a save, a load and 3
    more, bit for bit; the state round-trips field for field."""
    _, cp = configs(64, 6)
    ref = t(np.asarray(ref_path[:400]), F32)
    s0 = P.init_sim(cp, PSIM, seed=9, device="cpu")
    s_full, rec_full = P.simulate_fused(PARM, cp, PSIM, ref, s0, 6)
    s_half, _ = P.simulate_fused(PARM, cp, PSIM, ref, s0, 3)
    path = os.path.join(tmp_path, "state.npz")
    pck.save_checkpoint(path, s_half)
    s_res = pck.load_checkpoint(path, device="cpu")
    for a, b in zip((s_res.step, s_res.q, s_res.dq, s_res.done, *s_res.mppi),
                    (s_half.step, s_half.q, s_half.dq, s_half.done,
                     *s_half.mppi)):
        assert torch.equal(a, b)
    assert s_res.seed == 9 and int(s_res.step) == 3
    s_end, rec_tail = P.simulate_fused(PARM, cp, PSIM, ref, s_res, 3)
    for f, a, b in zip(rec_full._fields, rec_full, rec_tail):
        assert torch.equal(a[3:], b), f
    assert torch.equal(s_end.mppi.u_prev, s_full.mppi.u_prev)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_batched_checkpoint_round_trip(tmp_path):
    _, cp = configs(32, 5)
    states = P.init_sim_batch(cp, PSIM, [3, 0x7FFFFFFF, 12],
                              q0=np.random.default_rng(1).normal(size=(3, 2)),
                              device="cpu")
    path = os.path.join(tmp_path, "fleet.npz")
    pck.save_checkpoint(path, states)
    back = pck.load_checkpoint(path, device="cpu")
    assert torch.equal(back.seed, states.seed)
    for a, b in zip((back.step, back.q, back.dq, back.done, *back.mppi),
                    (states.step, states.q, states.dq, states.done,
                     *states.mppi)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("typed", [False, True])
def test_jax_checkpoint_loads_in_the_port(tmp_path, typed):
    """A JAX-written checkpoint (raw or typed key) gives the port the same
    state, with the seed the JAX fused loop derives from the key."""
    cj, _ = configs(32, 5)
    key = jax.random.key(77) if typed else jax.random.PRNGKey(77)
    js = J.init_sim(cj, JSIM, key)
    js = js._replace(step=jnp.asarray(12, jnp.int32),
                     q=js.q + 0.25,
                     mppi=js.mppi._replace(wp_idx=jnp.asarray(5, jnp.int32)))
    path = os.path.join(tmp_path, "jax.npz")
    jck.save_checkpoint(path, js)
    ps = pck.load_checkpoint(path, device="cpu")
    kd = (jax.random.key_data(js.key) if typed else js.key)
    assert ps.seed == convert.seed_from_key_data(np.asarray(kd)) == 77
    assert int(ps.step) == 12 and int(ps.mppi.wp_idx) == 5
    np.testing.assert_array_equal(n(ps.q), np.asarray(js.q))
    np.testing.assert_array_equal(n(ps.mppi.u_prev),
                                  np.asarray(js.mppi.u_prev))
    assert not bool(ps.done)
    # batched JAX states (legacy (B, 2) keys)
    jb = J.init_sim_batch(cj, JSIM, jax.vmap(jax.random.PRNGKey)(
        jnp.arange(5, 9)))
    jck.save_checkpoint(path, jb)
    pb = pck.load_checkpoint(path, device="cpu")
    assert pb.seed.tolist() == [5, 6, 7, 8]
    np.testing.assert_array_equal(n(pb.q), np.asarray(jb.q))


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port writes the JAX package's fields and dtypes; JAX loads them
    with a raw key whose derived fused-loop seed is the port's seed."""
    cj, cp = configs(32, 5)
    path_j = os.path.join(tmp_path, "jax.npz")
    path_p = os.path.join(tmp_path, "port.npz")
    jck.save_checkpoint(path_j, J.init_sim(cj, JSIM, jax.random.PRNGKey(0)))
    ps = P.init_sim(cp, PSIM, seed=123456, device="cpu")._replace(
        step=torch.tensor(40), mppi=P.MPPIState(
            u_prev=torch.full((5, 2), 0.5), wp_idx=torch.tensor(17)))
    pck.save_checkpoint(path_p, ps)
    zj, zp = _npz(path_j), _npz(path_p)
    assert sorted(zj) == sorted(zp)
    for f in zj:
        assert zj[f].dtype == zp[f].dtype and zj[f].shape == zp[f].shape, f
    js = jck.load_checkpoint(path_p)
    assert int(js.step) == 40 and int(js.mppi.wp_idx) == 17
    np.testing.assert_array_equal(np.asarray(js.mppi.u_prev), n(ps.mppi.u_prev))
    kd = np.asarray(js.key)
    seed = int((kd.reshape(-1)[-1].astype(np.uint32)
                & np.uint32(0x7FFFFFFF)))      # sim/loop.py:366-370
    assert seed == convert.seed_from_key_data(kd) == 123456
    # batched
    pb = P.init_sim_batch(cp, PSIM, [4, 9], device="cpu")
    pck.save_checkpoint(path_p, pb)
    jb = jck.load_checkpoint(path_p)
    assert np.asarray(jb.key).shape == (2, 2)
    assert [convert.seed_from_key_data(k) for k in np.asarray(jb.key)] \
        == [4, 9]


def test_checkpoint_missing_field(tmp_path):
    bad = os.path.join(tmp_path, "bad.npz")
    np.savez(bad, step=np.int32(0))
    for load in (pck.load_checkpoint, jck.load_checkpoint):
        with pytest.raises(ValueError, match="missing fields"):
            load(bad)


# ---- metrics and logging ------------------------------------------------------

def test_solve_metrics_and_nan_guard_match_jax():
    rng = np.random.default_rng(4)
    costs = rng.uniform(1.0, 50.0, size=64)
    w = np.exp(-(costs - costs.min()) / 5.0)
    w = w / w.sum()
    mj = jmet.solve_metrics(jnp.asarray(costs), jnp.asarray(w))
    mp = pmet.solve_metrics(t(costs), t(w))
    assert mj.keys() == mp.keys()
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=1e-12, err_msg=k)
    for arrays in ((np.ones(3),), (np.ones(3), np.array([1.0, np.nan])),
                   (np.array([np.inf]),)):
        assert pmet.nan_guard(*(t(a) for a in arrays)) == \
            jmet.nan_guard(*(jnp.asarray(a) for a in arrays))
    assert pmet.nan_guard(np.zeros(2), t([1.0]))


def test_metrics_logger_matches_jax():
    """The same record gives the same JSON lines, cadence included."""
    rng = np.random.default_rng(2)
    fields = dict(cost_min=rng.uniform(size=30).astype(np.float32),
                  cost_mean=rng.uniform(size=30).astype(np.float32),
                  ess=rng.uniform(1, 9, size=30).astype(np.float32),
                  weight_entropy=rng.uniform(size=30).astype(np.float32),
                  wp_idx=np.arange(30))
    rec_j = J.SimRecord(**{f: jnp.asarray(fields.get(f, np.zeros(30)))
                           for f in J.SimRecord._fields})
    rec_p = P.SimRecord(**{f: torch.as_tensor(fields.get(f, np.zeros(30)))
                           for f in P.SimRecord._fields})
    bj, bp = io.StringIO(), io.StringIO()
    jmet.MetricsLogger(stream=bj, every=7).log_record(rec_j, stride=7)
    pmet.MetricsLogger(stream=bp, every=7).log_record(rec_p, stride=7)
    assert bp.getvalue() == bj.getvalue()
    assert [json.loads(l)["step"] for l in bp.getvalue().splitlines()] == \
        [0, 7, 14, 21, 28]


# ---- timing ------------------------------------------------------------------

def test_simple_timeit_step_timer_and_trace(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2, [x + 1])

    r = ptime.simple_timeit(fn, torch.ones(3), warmup=2, reps=4, name="dbl")
    assert len(calls) == 6 and r.reps == 4 and r.name == "dbl"
    assert 0 < r.best_s <= r.mean_s and r.per_second == 1.0 / r.best_s
    assert "dbl: best" in str(r)
    with ptime.trace(None):
        pass
    log_dir = os.path.join(tmp_path, "prof")
    with ptime.trace(log_dir):
        torch.ones(8) @ torch.ones(8)
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


# ---- plotting ------------------------------------------------------------------

def _lines(fig):
    return [[ln.get_xydata() for ln in ax.get_lines()] for ax in fig.axes]


def test_plot_results_line_data_matches_jax(ref_path):
    rng = np.random.default_rng(6)
    steps = 12
    rec = P.SimRecord(**{f: rng.normal(size=(steps, 2)) if f in ("q", "u",
                                                                 "ee")
                         else np.zeros(steps) for f in P.SimRecord._fields})
    ref = np.asarray(ref_path[:8])                # shorter than the run
    figs_j = jplot.plot_results(rec, ref)
    figs_p = pplot.plot_results(P.SimRecord(*(torch.as_tensor(v)
                                              for v in rec)), ref)
    for fj, fp in zip(figs_j, figs_p):
        lj, lp = _lines(fj), _lines(fp)
        assert [len(a) for a in lj] == [len(a) for a in lp]
        for aj, ap in zip(lj, lp):
            for xj, xp in zip(aj, ap):
                np.testing.assert_array_equal(xp, xj)
        assert [ax.get_title() for ax in fj.axes] == \
            [ax.get_title() for ax in fp.axes]
    q = np.array([0.3, -0.7])
    sampled = rng.normal(size=(5, 4, 4))
    opt = rng.normal(size=(4, 4))
    order = np.array([3, 0, 4, 1, 2])
    fj = jplot.plot_sampled_trajectories(q, sampled, opt, ref, order)
    fp = pplot.plot_sampled_trajectories(torch.as_tensor(q), sampled,
                                         torch.as_tensor(opt), ref,
                                         torch.as_tensor(order))
    for xj, xp in zip(_lines(fj)[0], _lines(fp)[0]):
        np.testing.assert_array_equal(xp, xj)
    assert [ln.get_alpha() for ln in fj.axes[0].get_lines()] == \
        [ln.get_alpha() for ln in fp.axes[0].get_lines()]
    for xj, xp in zip(_lines(jplot.plot_arm_schematic((0.4, 1.1)))[0],
                      _lines(pplot.plot_arm_schematic((0.4, 1.1)))[0]):
        np.testing.assert_array_equal(xp, xj)
    import matplotlib.pyplot as plt
    plt.close("all")


def test_animate_arm_frame_content():
    """Every frame's link artists carry the FK of that frame's angles
    (visualize.py:17-31, l1 = l2 = 1), as tests/test_cli_render.py:28-54
    holds the JAX package's."""
    from mppi_robotarm_tpu_torch.models.arm import fk_full

    rng = np.random.default_rng(3)
    q_seq = rng.uniform(-np.pi, np.pi, size=(7, 2))
    anim = pplot.animate_arm(torch.as_tensor(q_seq))
    frames = list(anim.new_frame_seq())
    assert len(frames) == len(q_seq)
    anim._init_draw()
    for i in frames:
        link1, link2 = anim._func(i)
        x1, y1, x2, y2 = (float(v) for v in fk_full(
            torch.tensor(q_seq[i, 0]), torch.tensor(q_seq[i, 1]), PARM))
        np.testing.assert_allclose(link1.get_xydata(),
                                   [[0.0, 0.0], [x1, y1]], atol=1e-12)
        np.testing.assert_allclose(link2.get_xydata(),
                                   [[x1, y1], [x2, y2]], atol=1e-12)
    import matplotlib.pyplot as plt
    plt.close("all")


# ---- path loaders ------------------------------------------------------------

def test_joint_log_loaders_match_jax(tmp_path):
    """A [q1, q2, x, y] log: loaded and converted bit for bit in float32 as
    the JAX functions do; a wrong column count raises ValueError."""
    rng = np.random.default_rng(5)
    log = np.cumsum(rng.normal(scale=0.01, size=(50, 4)), axis=0)
    path = os.path.join(tmp_path, "trajectory.txt")
    np.savetxt(path, log)
    lj, lp = jpaths.load_joint_log(path), ppaths.load_joint_log(path)
    assert lp.dtype == lj.dtype == np.float32
    np.testing.assert_array_equal(lp, lj)
    rj = jpaths.ref_path_from_joint_log(lj)
    rp = P.ref_path_from_joint_log(lp)
    assert rp.dtype == np.float32 and rp.shape == (50, 4)
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(
        ppaths.ref_path_from_joint_log(log, dt=0.01, dtype=np.float64),
        jpaths.ref_path_from_joint_log(log, dt=0.01, dtype=np.float64))
    bad = os.path.join(tmp_path, "bad.txt")
    np.savetxt(bad, log[:, :3])
    with pytest.raises(ValueError):
        ppaths.load_joint_log(bad)
    with pytest.raises(ValueError):
        P.ref_path_from_joint_log(log[:, :3])


# ---- visualisation re-rollouts --------------------------------------------------

def test_viz_rollouts_match_jax_f64():
    cj, cp = configs(24, 7, u_clamp=30.0, exploration=0.25)
    rng = np.random.default_rng(8)
    obs = np.array([1.1522, -1.2661, 0.1, -0.2])
    u_prev = rng.normal(size=(7, 2)) * 5.0
    u_seq = u_prev + rng.normal(size=(7, 2))
    eps = eps_noise(2, (24, 7, 2), np.float64)
    costs = np.round(rng.uniform(size=24), 1)        # ties: stable order
    vj = J.viz_rollouts(JARM, cj, jnp.asarray(obs), jnp.asarray(u_seq),
                        jnp.asarray(u_prev), jnp.asarray(eps),
                        jnp.asarray(costs))
    vp = viz_rollouts(PARM, cp, t(obs), t(u_seq), t(u_prev), t(eps), t(costs))
    np.testing.assert_allclose(n(vp.optimal_traj), np.asarray(vj.optimal_traj),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(n(vp.sampled_trajs),
                               np.asarray(vj.sampled_trajs), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(n(vp.sorted_idx), np.asarray(vj.sorted_idx))
    with pytest.raises(ValueError, match="want_eps"):
        viz_rollouts(PARM, cp, t(obs), t(u_seq), t(u_prev), None, t(costs))
