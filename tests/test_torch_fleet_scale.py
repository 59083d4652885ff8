"""A fleet's scenarios do not depend on the fleet's size: BASELINE config 5
(32,768 scenarios) against config 4 (4096), at a size the CPU runs.

NumPy draws the fleet's q0 row by row and the seeds are ``arange``, so the
first scenarios of a larger fleet are the smaller fleet.  On the CPU (the
kernels' plain versions):
* scenarios 0-15 of a 128-scenario ``simulate_fused_batch`` (K = 16,
  T = 5, q0 from ``default_rng(9)``, seeds ``arange``) and of
  ``simulate_batch(backend="cuda")`` equal the 16-scenario run's, bit for
  bit, every record field and the final state;
* ``parallel/dryrun.py --fleet-scenarios`` at the tiny size over gloo in
  two processes, a (2 x 1) mesh: each rank's records and final state equal
  its rows of the unsharded run (as tests/test_torch_parallel.py holds the
  default fleet), and a fleet that is no multiple of the 'data' size is
  refused.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.parallel import dryrun
from mppi_robotarm_tpu_torch.sim.loop import _state_tensors

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM, SIM = P.ArmParams(), P.SimConfig()
CFG = dataclasses.replace(P.MPPIConfig(), num_samples=16, horizon=5)
SMALL, LARGE, STEPS = 16, 128, 12


def _fleet(B):
    q0 = (np.array([[1.1522, -1.2661]])
          + 0.01 * np.random.default_rng(9).normal(size=(B, 2)))
    return P.init_sim_batch(CFG, SIM, np.arange(B),
                            q0=q0.astype(np.float32), device="cpu")


@pytest.mark.parametrize("path", ["fused", "per-step"])
def test_a_fleets_first_scenarios_are_the_smaller_fleet(path):
    ref = torch.as_tensor(P.synth_circle_path(200))

    def run(B):
        if path == "fused":
            return P.simulate_fused_batch(ARM, CFG, SIM, ref, _fleet(B),
                                          STEPS)
        return P.simulate_batch(ARM, CFG, SIM, ref, _fleet(B), STEPS,
                                backend="cuda")

    final_s, rec_s = run(SMALL)
    final_l, rec_l = run(LARGE)
    for field, a, b in zip(rec_s._fields, rec_l, rec_s):
        assert a.shape[:2] == (STEPS, LARGE), field
        assert torch.equal(a[:, :SMALL], b), field
    for a, b in zip(_state_tensors(final_l), _state_tensors(final_s)):
        assert torch.equal(a[:SMALL], b)
    # the larger fleet's other scenarios ran: they moved, and differ
    assert not torch.equal(rec_l.q[:, SMALL:2 * SMALL], rec_s.q)


def test_dryrun_fleet_scenarios_ranks_equal_their_rows(tmp_path):
    B = 24
    out = str(tmp_path / "dr")
    r = subprocess.run(
        [sys.executable, "-m", "mppi_robotarm_tpu_torch.parallel.dryrun",
         "--world", "2", "--data", "2", "--samples", "1", "--device", "cpu",
         "--out", out, "--programs", "fleet", "--fleet-scenarios", str(B)],
        cwd=REPO, capture_output=True, text=True,
        timeout=dryrun.TIMEOUT_S + 60)
    assert r.returncode == 0, r.stdout + r.stderr
    ranks = [dict(np.load(os.path.join(out, f"rank{k}.npz")))
             for k in range(2)]
    arm, sim, _, (fcfg, fpath, fB, fsteps) = dryrun.problem("tiny", 2, 1, B)
    assert fB == B
    states = P.init_sim_batch(fcfg, sim, np.arange(fB),
                              q0=dryrun.fleet_q0("tiny", fB, sim),
                              device="cpu")
    final, rec = P.simulate_fused_batch(arm, fcfg, sim,
                                        torch.as_tensor(fpath), states,
                                        fsteps)
    b = B // 2
    for z in ranks:
        d = int(z["data_rank"])
        rows = slice(d * b, (d + 1) * b)
        for f in dryrun.FLEET_FIELDS:
            np.testing.assert_array_equal(z[f"fleet_{f}"],
                                          getattr(rec, f)[:, rows].numpy(),
                                          err_msg=f"{f} rank {d}")
        np.testing.assert_array_equal(z["fleet_u_final"],
                                      final.mppi.u_prev[rows].numpy())
        np.testing.assert_array_equal(z["fleet_step"],
                                      final.step[rows].numpy())
        assert bool(z["fleet_checkpoint_bitwise"])
        assert int(z["fleet_peak_bytes"]) == 0     # no card: nothing read
        assert float(z["fleet_us_per_launch_step"]) > 0


@pytest.mark.parametrize("n", ["5", "0"])
def test_dryrun_refuses_a_fleet_the_mesh_cannot_cut(n, capsys):
    with pytest.raises(SystemExit):
        dryrun.parse_args(["--world", "2", "--data", "2", "--samples", "1",
                           "--out", "x", "--fleet-scenarios", n])
    assert "--fleet-scenarios" in capsys.readouterr().err


def test_the_default_fleet_is_the_sizes_own():
    for size, data, want in (("tiny", 2, 4), ("full", 2, 4096)):
        assert dryrun.problem(size, data, 1)[3][2] == want
    assert dryrun.problem("full", 2, 1, 32768)[3][2] == 32768
    assert np.array_equal(dryrun.fleet_q0("full", 32768, SIM)[:4096],
                          dryrun.fleet_q0("full", 4096, SIM))


def test_the_checkpoint_comparison_is_bitwise_with_nans():
    """A diverged scenario's NaN state round-trips: the dry run compares
    bits, where ``torch.equal`` calls two NaNs different."""
    x = torch.tensor([1.0, float("nan"), -0.0])
    assert not torch.equal(x, x.clone())
    assert torch.equal(dryrun._bits(x), dryrun._bits(x.clone()))
    assert not torch.equal(dryrun._bits(x), dryrun._bits(
        torch.tensor([1.0, float("nan"), 0.0])))
    assert dryrun._bits(x.double()).dtype == torch.int64
    assert torch.equal(dryrun._bits(torch.arange(3)), torch.arange(3))
