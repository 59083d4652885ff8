"""The check that decides ``correct``, driven through the rest of a run at
a small size on the CPU (the port's plain versions in place of its
kernels): a sound run passes, each fault planted in the timed path
fails, and so does the control, the reference in bfloat16 put in the
program's place.  On a card, the control at each cell's own size."""

import copy
import time

import pytest
import torch

import mppi_robotarm_tpu_torch.mppi.solver as solver
import mppi_robotarm_tpu_torch.sim.loop as loop
from mppi_robotarm_tpu_torch.ops import cuda_rollout, cuda_sim, cuda_solve, \
    cuda_step
from portbench import control, harness, judge

TINY = {
    "arm_k1024_h50.fused": dict(chain_steps=30, check_from=4),
    "arm_k1024_h50.steploop": dict(chain_steps=30, check_from=4),
    "fleet4096_k128_t30.fused": dict(chain_steps=20, check_from=4),
    "arm_k1024_h50.realtime": dict(episode_steps=40, keep_every=7),
}
SEED = 2 ** 33 + 17


def tiny(name):
    """The cell at K=16, T=6 on a 400-row path (a 16-scenario fleet), its
    limits as they stand."""
    cell = harness.load_cell(name)
    conf = copy.deepcopy(cell.conf)
    conf["mppi"].update(num_samples=16, horizon=6)
    conf["path"]["waypoints"] = 400
    if "fleet" in conf:
        conf["fleet"]["scenarios"] = 16
    return cell._replace(conf=conf, traffic={**cell.traffic, **TINY[name]})


def run(name):
    out = harness.measure(tiny(name), SEED, 0.3, False, torch.device("cpu"),
                          time.perf_counter(), log=lambda *a: None)
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _unchanged(monkeypatch, name):
    """Each step hands its state back as it found it: the plant (loops)
    or the control update (a solve) does nothing."""
    if name == "arm_k1024_h50.realtime":
        orig = solver._solve_kernels

        def kernels(arm, cfg, x, u_prev, *a):
            u_seq, s, eps = orig(arm, cfg, x, u_prev, *a)
            return u_prev.clone(), s, eps
        monkeypatch.setattr(solver, "_solve_kernels", kernels)
    elif name == "arm_k1024_h50.steploop":
        monkeypatch.setattr(cuda_step, "plant_step",
                            lambda arm, sim, q, dq, u: (q, dq))
    else:
        monkeypatch.setattr(cuda_sim, "dynamics_step",
                            lambda q1, q2, dq1, dq2, *a: (q1, q2, dq1, dq2))


def _half_samples(monkeypatch, name):
    """Half the samples left out of the softmax, the weighted mean taken
    over the rest."""
    def half(*a, **k):
        s = cuda_rollout.rollout_cost_trig(*a, **k)
        s[..., s.shape[-1] // 2:] = 1e30
        return s
    mod = cuda_solve if name.endswith((".realtime", ".steploop")) else \
        cuda_sim
    monkeypatch.setattr(mod, "rollout_cost_trig", half)


def _half_fleet(monkeypatch, name):
    """Half the fleet's scenarios left out: their rows copied from the
    others'."""
    orig = loop.fused_sim_run_batched

    def launch(*a, **k):
        rows, u = orig(*a, **k)
        h = rows.shape[0] // 2
        rows[h:] = rows[:rows.shape[0] - h].clone()
        u[h:] = u[:u.shape[0] - h].clone()
        return rows, u
    monkeypatch.setattr(loop, "fused_sim_run_batched", launch)


def _altered(monkeypatch, name):
    """The control each step applies is altered where it is produced."""
    if name == "arm_k1024_h50.realtime":
        orig = solver._solve_one_cuda

        def one(*a):
            res = orig(*a)
            return res._replace(u0=res.u0 + 0.5)
        monkeypatch.setattr(solver, "_solve_one_cuda", one)
    elif name == "arm_k1024_h50.steploop":
        orig = cuda_step.step_tail

        def tail(*a, **k):
            out = orig(*a, **k)
            row = a[15] if len(a) > 15 else k.get("row")
            if row is not None:
                row[2].add_(0.5)
            return out
        monkeypatch.setattr(cuda_step, "step_tail", tail)
    else:
        orig = loop.fused_sim_run_batched

        def launch(*a, **k):
            rows, u = orig(*a, **k)
            rows[..., 4] += 0.5
            return rows, u
        monkeypatch.setattr(loop, "fused_sim_run_batched", launch)


FAULTS = [(n, f) for n in sorted(TINY)
          for f in (_unchanged, _half_samples, _altered)] + [
    ("fleet4096_k128_t30.fused", _half_fleet)]


@pytest.mark.parametrize("name, fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch, name)
    out = run(name)
    assert not out["correct"], out["checks"]


def _control_readings(name, seconds, device, seeds):
    cell = tiny(name) if device.type == "cpu" else harness.load_cell(name)
    driver = harness.load(cell.root, "drivers", cell.traffic["driver"])
    return cell, [control.seed_readings(cell, driver, s, seconds, device,
                                        True) for s in seeds]


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_bfloat16_control_is_not_correct(name):
    cell, outs = _control_readings(name, 0.3, torch.device("cpu"), [SEED])
    for o in outs:
        assert judge.verdict(o["program"], cell.limits)[0], o
        assert not judge.verdict(o["control"], cell.limits)[0], o


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_the_bfloat16_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size on the card")
    cell, outs = _control_readings(name, 3.0, torch.device("cuda", 0),
                                   [11, 2 ** 31 + 3, 2 ** 40 + 5])
    for o in outs:
        assert not judge.verdict(o["control"], cell.limits)[0], o
