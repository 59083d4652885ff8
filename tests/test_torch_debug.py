"""The port's debug and sanitizer modes (``utils/debug.py``), as
``tests/test_debug.py`` holds the JAX package's: the checked solve against
JAX's checkified one, ``debug_mode`` in the loops, the race check's
command and its refusal to pass when the sanitizer cannot run, and the
poison → detect → restore → bitwise fault drill.

The cuda-marked tests at the end are chip_smoke phase 18's twins; they
import nothing of JAX, so on a GPU machine without JAX

    python -m pytest --noconftest tests/test_torch_debug.py -m cuda
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops.waypoint import slice_window
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.tools import sanitize
from mppi_robotarm_tpu_torch.utils import debug
from mppi_robotarm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from mppi_robotarm_tpu_torch.utils.debug import (checked_solve, debug_mode,
                                                 kernel_race_check)
from mppi_robotarm_tpu_torch.utils.metrics import nan_guard

try:        # the GPU machine has no JAX: there only the cuda tests run
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    from mppi_robotarm_tpu.mppi.solver import MPPIState as JState
    from mppi_robotarm_tpu.utils.debug import checked_solve as jchecked
except ImportError:
    jnp = None

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()
CFG = P.MPPIConfig()
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0])
F64 = torch.float64



def _eps(seed, cfg=CFG):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.num_samples, cfg.horizon, 2)) * np.sqrt(20.0)


def _end_state(ref, cfg):
    """The EE at the path's last row and the index two rows before it: the
    solve advances to the end (Q6)."""
    n = ref.shape[0]
    tx, ty = ref[n - 1, 0], ref[n - 1, 1]
    c2 = np.clip((tx * tx + ty * ty - 2.0) / 2.0, -1, 1)
    q2 = np.arccos(c2)
    q1 = np.arctan2(ty, tx) - np.arctan2(np.sin(q2), 1 + np.cos(q2))
    st = P.init_state(cfg, dtype=F64, device="cpu")._replace(
        wp_idx=torch.tensor(n - 2))
    return torch.tensor([q1, q2, 0.0, 0.0], dtype=F64), st


def test_checked_solve_ok_matches_jax(ref_path):
    eps = _eps(0)
    err, res = checked_solve(ARM, CFG, torch.as_tensor(ref_path),
                             torch.as_tensor(X0),
                             P.init_state(CFG, dtype=F64, device="cpu"),
                             eps=torch.as_tensor(eps))
    err.throw()
    assert err.get() is None
    jerr, jres = jchecked(J.ArmParams(), J.MPPIConfig(), jnp.asarray(ref_path),
                          jnp.asarray(X0), J.init_state(J.MPPIConfig(),
                                                        dtype=jnp.float64),
                          eps=jnp.asarray(eps))
    jerr.throw()
    np.testing.assert_allclose(res.u0.numpy(), np.asarray(jres.u0),
                               rtol=1e-12, atol=1e-12)


def test_checked_solve_path_end_raises(ref_path):
    ref = np.asarray(ref_path)
    x, st = _end_state(ref, CFG)
    err, _ = checked_solve(ARM, CFG, torch.as_tensor(ref), x, st,
                           eps=torch.as_tensor(_eps(1)))
    assert err.get() == "Reached the end of the reference path."
    with pytest.raises(IndexError, match="end of the reference path"):
        err.throw()
    jerr, _ = jchecked(J.ArmParams(), J.MPPIConfig(), jnp.asarray(ref),
                       jnp.asarray(x.numpy()), JState(
                           u_prev=jnp.asarray(st.u_prev.numpy()),
                           wp_idx=jnp.asarray(ref.shape[0] - 2, jnp.int32)),
                       eps=jnp.asarray(_eps(1)))
    with pytest.raises(Exception, match="end of the reference path"):
        jerr.throw()


def _cut_at_closing(path):
    """The circle up to its first closing row: a synthesised circle ends on
    rows that repeat its start's x, y, and here the last two rows differ."""
    xy_moves = np.any(np.diff(path[:, :2], axis=0) != 0, axis=1)
    return path[:np.flatnonzero(xy_moves).max() + 2]


@pytest.mark.parametrize("cut", [False, True], ids=["closing-rows", "cut"])
def test_checked_solve_two_rows_before_the_end_matches_jax(cut):
    """From two rows before the end of synth_circle_path(2000), the EE at
    the start (= the end) of the circle: on the full path the last rows tie
    in x, y and the first of them wins (the reference's tie rule), so the
    index stays below the end, in JAX as in the port; cut at its first
    closing row, the solve reaches the end, in both."""
    path = P.synth_circle_path(2000).astype(np.float64)
    if cut:
        path = _cut_at_closing(path)
    n = path.shape[0]
    st = P.init_state(CFG, dtype=F64, device="cpu")._replace(
        wp_idx=torch.tensor(n - 2))
    err, res = checked_solve(ARM, CFG, torch.as_tensor(path),
                             torch.as_tensor(X0), st,
                             eps=torch.as_tensor(_eps(1)))
    jerr, jres = jchecked(J.ArmParams(), J.MPPIConfig(), jnp.asarray(path),
                          jnp.asarray(X0), JState(
                              u_prev=jnp.asarray(st.u_prev.numpy()),
                              wp_idx=jnp.asarray(n - 2, jnp.int32)),
                          eps=jnp.asarray(_eps(1)))
    assert int(res.state.wp_idx) == int(jres.state.wp_idx) == n - 2 + cut
    assert err.get() == (debug.CheckError.PATH_END if cut else None)
    assert (jerr.get() is not None) == cut
    np.testing.assert_allclose(res.u0.numpy(), np.asarray(jres.u0),
                               rtol=1e-12, atol=1e-12)


def test_checked_solve_non_finite_raises(ref_path):
    st = P.init_state(CFG, dtype=F64, device="cpu")
    st = st._replace(u_prev=st.u_prev.clone().index_fill_(
        0, torch.tensor([3]), float("nan")))
    err, _ = checked_solve(ARM, CFG, torch.as_tensor(ref_path),
                           torch.as_tensor(X0), st,
                           eps=torch.as_tensor(_eps(2)))
    with pytest.raises(FloatingPointError, match="non-finite control"):
        err.throw()


def test_debug_mode_restores_flags():
    before = (debug._MODE.nans, debug._MODE.checks)
    with debug_mode():
        assert debug.active() and debug._MODE.nans and debug._MODE.checks
        with debug_mode(nans=False):
            assert not debug._MODE.nans and debug._MODE.checks
        assert debug._MODE.nans
    assert (debug._MODE.nans, debug._MODE.checks) == before
    assert not debug.active()


@pytest.mark.parametrize("loop", ["simulate", "simulate_batch",
                                  "simulate_fused_batch", "solve"])
def test_debug_mode_catches_a_poisoned_state(loop):
    """A NaN in the state: silent outside debug_mode, FloatingPointError
    under it, from each loop (after the step, chunk or launch)."""
    cfg = dataclasses.replace(CFG, num_samples=16, horizon=6)
    ref = torch.as_tensor(P.synth_circle_path(300))
    st = P.init_sim(cfg, SIM, seed=1, device="cpu")
    st = st._replace(q=torch.tensor([float("nan"), -1.2661]))

    def run():
        if loop == "simulate":
            return P.simulate(ARM, cfg, SIM, ref, st, 3)
        if loop == "solve":
            return P.solve(ARM, cfg, ref, torch.cat([st.q, st.dq]), st.mppi,
                           eps=torch.as_tensor(_eps(0, cfg)))
        batch = ploop._as_batch(st)
        if loop == "simulate_batch":
            return P.simulate_batch(ARM, cfg, SIM, ref, batch, 3,
                                    backend="cuda")
        return P.simulate_fused_batch(ARM, cfg, SIM, ref, batch, 3)

    run()                                   # silent outside the mode
    with debug_mode():
        with pytest.raises(FloatingPointError, match="non-finite"):
            run()
    with debug_mode(nans=False):
        run()                               # invariants hold, NaN or not


def test_debug_mode_invariants():
    cfg = dataclasses.replace(CFG, num_samples=16, horizon=6)
    b = ploop._as_batch(P.init_sim(cfg, SIM, seed=1, device="cpu"))
    good = b._replace(step=b.step + 2, mppi=b.mppi._replace(
        wp_idx=b.mppi.wp_idx + 3))
    with debug_mode():
        debug.check_step("t", b, good, 100, steps=2)
        for before, after, text in (
                (b, good._replace(mppi=good.mppi._replace(
                    wp_idx=torch.tensor([100]))), "outside"),
                (good, good._replace(mppi=good.mppi._replace(
                    wp_idx=torch.tensor([2]))), "moved back"),
                (b, good._replace(step=b.step + 3), "past the 2 steps"),
                (good, good._replace(step=b.step), "moved back or past"),
                (b._replace(done=torch.tensor([True])), good, "undone")):
            with pytest.raises(RuntimeError, match=text):
                debug.check_step("t", before, after, 100, steps=2)
    debug.check_step("t", b, b._replace(step=b.step - 1), 100)   # mode off


def test_kernel_race_check_command_and_refusals(monkeypatch):
    """The command it forms, and that it never passes a check that did not
    run: no sanitizer, "Device not supported", a reported hazard."""
    cmd = debug.race_check_command("/x/compute-sanitizer", "/w")
    assert cmd[:5] == ["/x/compute-sanitizer", "--tool", "racecheck",
                       "--error-exitcode", "9"]
    assert cmd[-4:] == ["-m", "mppi_robotarm_tpu_torch.utils.debug",
                        "--race-case", "/w"]
    cfg = dataclasses.replace(CFG, num_samples=256, horizon=4)
    x0 = torch.tensor(X0, dtype=torch.float32)
    u = torch.tensor(cfg.warm_start).repeat(4, 1)
    window, valid = slice_window(torch.as_tensor(
        P.synth_circle_path(300)), 0, cfg.search_idx_len)
    eps = torch.as_tensor(_eps(4, cfg).astype(np.float32))
    args = (ARM, cfg, x0, u, window.float(), valid.sum(), eps)

    monkeypatch.setattr(sanitize, "sanitizer_path", lambda: None)
    with pytest.raises(RuntimeError, match="not found"):
        kernel_race_check(*args)
    monkeypatch.setattr(sanitize, "sanitizer_path",
                        lambda: "/x/compute-sanitizer")
    seen = []

    def answer(text, rc, outputs=False):
        def run(argv, **kw):
            seen.append(argv)
            if outputs:
                w = argv[-1]
                np.savez(os.path.join(w, "outputs.npz"), w_eps=np.ones(
                    (4, 2)), s=np.ones(256), eps=np.ones((256, 4, 2)))
            return subprocess.CompletedProcess(argv, rc, text, "")
        monkeypatch.setattr(subprocess, "run", run)

    answer("========= Error: Device not supported\n", 1)
    with pytest.raises(RuntimeError, match="Device not supported"):
        kernel_race_check(*args)
    assert seen[-1][:3] == ["/x/compute-sanitizer", "--tool", "racecheck"]
    answer("========= ERROR SUMMARY: 2 errors\n", 9)
    with pytest.raises(RuntimeError, match="racecheck errors 2"):
        kernel_race_check(*args)
    answer("no summary at all\n", 0)
    with pytest.raises(RuntimeError, match="racecheck errors None"):
        kernel_race_check(*args)
    answer("========= ERROR SUMMARY: 0 errors\n", 0, outputs=True)
    w_eps, s, e = kernel_race_check(*args)
    assert w_eps.shape == (4, 2) and s.shape == (256,)


def test_race_case_inputs_round_trip(tmp_path, monkeypatch):
    """What the sanitized process reads: the inputs and the configs as the
    parent wrote them, and no tile (it launches at the main path's); the
    launch itself needs the card."""
    from mppi_robotarm_tpu_torch.config import config_from_json

    cfg = dataclasses.replace(CFG, num_samples=64, horizon=4)
    monkeypatch.setattr(sanitize, "sanitizer_path", lambda: "/x/cs")
    kept = {}

    def run(argv, **kw):
        w = argv[-1]
        kept["inputs"] = dict(np.load(os.path.join(w, "inputs.npz")))
        kept["case"] = open(os.path.join(w, "case.json")).read()
        return subprocess.CompletedProcess(argv, 1, "Device not supported",
                                           "")

    monkeypatch.setattr(subprocess, "run", run)
    eps = _eps(5, cfg).astype(np.float32)
    with pytest.raises(RuntimeError):
        kernel_race_check(ARM, cfg, torch.zeros(4), torch.zeros(4, 2),
                          torch.zeros(30, 4), 30.0, torch.as_tensor(eps))
    np.testing.assert_array_equal(kept["inputs"]["eps"], eps)
    assert sorted(kept["inputs"]) == ["eps", "u", "window", "x0"]
    import json
    case = json.loads(kept["case"])
    assert list(case) == ["config"]
    assert config_from_json(case["config"])[1] == cfg


def test_fault_injection_checkpoint_recovery(tmp_path):
    """The drill of tests/test_debug.py: NaN-poison the closed-loop state
    mid-run, detect it (nan_guard, and debug_mode at the first step),
    restart from the last checkpoint, and finish bit for bit as the
    uninterrupted run."""
    cfg = dataclasses.replace(CFG, num_samples=32, horizon=6)
    ref = torch.as_tensor(P.synth_circle_path(2000))
    total, pre = 12, 5
    ref_final, _ = P.simulate(ARM, cfg, SIM, ref,
                              P.init_sim(cfg, SIM, seed=11, device="cpu"),
                              total)
    mid, _ = P.simulate(ARM, cfg, SIM, ref,
                        P.init_sim(cfg, SIM, seed=11, device="cpu"), pre)
    ckpt = str(tmp_path / "drill.npz")
    save_checkpoint(ckpt, mid)
    poisoned = mid._replace(q=mid.q.clone().index_fill_(
        0, torch.tensor([0]), float("nan")))
    bad_final, bad_rec = P.simulate(ARM, cfg, SIM, ref, poisoned, total - pre)
    assert not nan_guard(bad_final.q), "fault must be detectable"
    assert not nan_guard(bad_rec.u)
    with debug_mode(), pytest.raises(FloatingPointError):
        P.simulate(ARM, cfg, SIM, ref, poisoned, total - pre)

    restored = load_checkpoint(ckpt, device="cpu")
    rec_final, _ = P.simulate(ARM, cfg, SIM, ref, restored, total - pre)
    for field in ("q", "dq", "done", "step"):
        assert torch.equal(getattr(rec_final, field),
                           getattr(ref_final, field)), field
    assert torch.equal(rec_final.mppi.u_prev, ref_final.mppi.u_prev)
    assert int(rec_final.mppi.wp_idx) == int(ref_final.mppi.wp_idx)
    assert rec_final.seed == ref_final.seed


# ---- on the card (chip_smoke phase 18) --------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the solve kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_checked_solve_on_the_card(dev):
    """backend="cuda" (the solve kernel): clean mid-path, raises at the
    path end and on a poisoned u_prev."""
    arm, cfg, _ = P.benchmark_preset()
    ref_np = P.synth_circle_path(2000)
    ref = torch.as_tensor(ref_np, device=dev)
    x = torch.tensor(X0, dtype=torch.float32, device=dev)
    st = P.init_state(cfg, device=dev)
    err, res = checked_solve(arm, cfg, ref, x, st, backend="cuda", seed=3)
    err.throw()
    assert bool(torch.isfinite(res.u0).all())
    # two rows before the end of the circle cut at its first closing row
    # (on the full circle the closing rows tie and the index stays below
    # the end, as in JAX: test_checked_solve_two_rows_before_the_end_...)
    cut = torch.as_tensor(_cut_at_closing(ref_np), device=dev)
    ste = st._replace(wp_idx=torch.tensor(len(cut) - 2, device=dev))
    err, res = checked_solve(arm, cfg, cut, x, ste, backend="cuda", seed=3)
    assert int(res.state.wp_idx) == len(cut) - 1
    with pytest.raises(IndexError):
        err.throw()
    bad = st._replace(u_prev=st.u_prev.clone().fill_(float("nan")))
    err, _ = checked_solve(arm, cfg, ref, x, bad, backend="cuda", seed=3)
    with pytest.raises(FloatingPointError):
        err.throw()


@pytest.mark.cuda
def test_debug_mode_between_graph_chunks(dev):
    """Under debug_mode the graph loop checks after each replayed chunk:
    a poisoned state raises, a clean one runs with the graphs' bits."""
    arm, cfg, sim = P.benchmark_preset()
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    st = P.init_sim(cfg, sim, seed=0, device=dev)
    _, want = P.simulate(arm, cfg, sim, ref, st, 40, backend="cuda")
    with debug_mode():
        _, got = P.simulate(arm, cfg, sim, ref, st, 40, backend="cuda")
        with pytest.raises(FloatingPointError):
            P.simulate(arm, cfg, sim, ref, st._replace(
                q=torch.full_like(st.q, float("nan"))), 40, backend="cuda")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
