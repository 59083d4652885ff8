"""The fleet's step-loop cell (``fleet4096_k128_t30.steploop``, BASELINE
config 4 through ``simulate_batch(backend="cuda")``) on the CPU: its
parts found by name, the layouts its ``why`` names, a whole run of the
harness at a small size, the check's faults and control, and its
readers.  On a card, the control at the cell's own size and the launch
counts of the layouts the ``why`` names."""

import copy
import types

import pytest
import torch

import mppi_robotarm_tpu_torch.sim.loop as loop
import test_portbench_faults as faults
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step
from portbench import control, harness, judge, program, roofline
from portbench.trace import Trace
from test_portbench_largek import _control, _measure
from test_portbench_stats_branch import _read

NAME = "fleet4096_k128_t30.steploop"
SEED = 2 ** 33 + 17
STEP_LOOP = "arm_k1024_h50.steploop"     # the step loop's planted faults


def test_the_cell_and_its_parts_are_found_by_name():
    """The fleet's configuration, unchanged, under its own traffic and
    driver, judged as rows with the fleet cell's readings held."""
    cell = harness.load_cell(NAME)
    fused = harness.load_cell("fleet4096_k128_t30.fused")
    assert cell.conf == fused.conf and cell.chips == 1
    assert cell.traffic == {"driver": "fleet_step_loop", "chain_steps": 256,
                            "check_chains": 3, "check_from": 16}
    driver = harness.load(cell.root, "drivers", cell.traffic["driver"])
    assert driver.KIND == "rows"
    assert set(cell.limits) == set(fused.limits)
    assert [m["name"] for m in cell.end_to_end] == ["solves_per_s",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "k2_roofline.fleet", "s2_us.fleet", "device_idle", "solve_mfu"}


def test_the_layouts_the_cells_why_names():
    """On the H100 (132 SMs, 15 cluster slots) the 4096 scenarios of 128
    samples solve in one tile each at one lane a sample, the window scan
    at its compiled width; the tail runs whole (no branch below K = 1024),
    four scenarios a block of one statistics warp each."""
    _, cfg, _ = program.configs(harness.load_cell(NAME).conf)
    B, K, sms, slots = 4096, 128, 132, 15
    assert (cfg.num_samples, cfg.horizon, cfg.search_idx_len) == (K, 30, 30)
    plan = cuda_solve._plan(cfg, K, None, True, True, B, sms)
    assert plan == (128, 1, 1, 1)
    assert cuda_sim.scan_width(cfg.search_idx_len, plan[2]) == 30
    assert not cuda_step.stats_branch(K, B, sms, plan)
    for s in (0, slots):
        assert cuda_step.step_tail_layout(K, B, sms, s) == \
            cuda_step.TailLayout(1, 4, 4, 1)
    assert cuda_step.tail_layout_fits(cuda_step.TailLayout(1, 4, 4, 1), K)


def _tiny(**traffic):
    """The cell at K=16, T=6 on a 400-row path, a 16-scenario fleet, its
    limits as they stand (``test_portbench_faults.tiny``'s size)."""
    cell = harness.load_cell(NAME)
    conf = copy.deepcopy(cell.conf)
    conf["mppi"].update(num_samples=16, horizon=6)
    conf["path"]["waypoints"] = 400
    conf["fleet"]["scenarios"] = 16
    tr = {**cell.traffic, "chain_steps": 20, "check_from": 4, **traffic}
    return cell._replace(conf=conf, traffic=tr)


def test_a_sound_run_is_correct():
    out = _measure(_tiny())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["attempted"] % 16 == 0


def test_a_run_at_the_fleets_k_and_horizon_is_correct():
    """K=128, T=30 and the 2000-row path, the cell's own, over 32
    scenarios: the check covers every scenario of the chains it draws."""
    cell = _tiny(chain_steps=6, check_from=3)
    cell.conf["mppi"].update(num_samples=128, horizon=30)
    cell.conf["path"]["waypoints"] = 2000
    cell.conf["fleet"]["scenarios"] = 32
    out = _measure(cell)
    assert out["correct"], out["checks"]


def _half_fleet(monkeypatch, name):
    """Half the fleet's scenarios left out of the solve: their controls
    copied from the others'."""
    orig = loop._solve_kernels

    def solve(*a, **k):
        u_seq, s, eps = orig(*a, **k)
        h = u_seq.shape[0] // 2
        u_seq[h:] = u_seq[:u_seq.shape[0] - h].clone()
        return u_seq, s, eps
    monkeypatch.setattr(loop, "_solve_kernels", solve)


FAULTS = (faults._unchanged, faults._half_samples, faults._altered,
          _half_fleet)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch, STEP_LOOP)
    out = _measure(_tiny())
    assert not out["correct"], out["checks"]


def test_the_bfloat16_control_is_not_correct():
    cell = _tiny()
    assert control.below(cell.conf) == torch.bfloat16
    for o in _control(cell, 0.3, torch.device("cpu"), [SEED]):
        assert judge.verdict(o["program"], cell.limits)[0], o
        assert not judge.verdict(o["control"], cell.limits)[0], o


@pytest.mark.cuda
def test_the_bfloat16_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size on the card")
    cell = harness.load_cell(NAME)
    for o in _control(cell, 3.0, torch.device("cuda", 0),
                      [11, 2 ** 31 + 3, 2 ** 40 + 5]):
        assert judge.verdict(o["program"], cell.limits)[0], o
        assert not judge.verdict(o["control"], cell.limits)[0], o


COUNTS = ("LAUNCHES", "COMPILED_SCANS", "TAIL_LAUNCHES", "STATS_LAUNCHES",
          "CLUSTER_TAILS")


def window_counts(name: str, seconds: float) -> dict:
    """The port's launch counts over one window of the cell ``name`` at
    its own size on the card, after its set-up: the solve's launches and
    compiled scans, the step tails, statistics launches and tails on a
    cluster."""
    cell = harness.load_cell(name)
    driver = harness.load(cell.root, "drivers", cell.traffic["driver"])
    ctx = driver.prepare(cell, SEED, torch.device("cuda", 0))
    mods = {"LAUNCHES": cuda_solve, "COMPILED_SCANS": cuda_solve,
            "TAIL_LAUNCHES": cuda_step, "STATS_LAUNCHES": cuda_step,
            "CLUSTER_TAILS": cuda_step}
    before = {k: getattr(mods[k], k) for k in COUNTS}
    win = driver.window(ctx, seconds)
    return {"calls": win.calls, **{k: getattr(mods[k], k) - before[k]
                                   for k in COUNTS}}


@pytest.mark.cuda
def test_the_counts_confirm_the_layouts_on_the_card():
    """Every solve of the window took the compiled-width scan, and no
    statistics ran on their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size on the card")
    n = window_counts(NAME, 2.0)
    assert n["LAUNCHES"] == n["calls"] * 256 > 0, n
    assert n["COMPILED_SCANS"] == n["LAUNCHES"], n
    assert n["TAIL_LAUNCHES"] == n["LAUNCHES"], n
    assert n["STATS_LAUNCHES"] == 0 and n["CLUSTER_TAILS"] == 0, n


# ---- the cell's readers ----------------------------------------------------

def _run(ops, counters, solves):
    window = types.SimpleNamespace(
        counters={**{k: 0 for k in program.counters()}, **counters},
        solves=solves)
    span = (0, max((b for _, _, b in ops), default=0))
    return harness.Run(harness.load_cell(NAME), window, Trace(ops, span),
                       1.0, 0)


def _steps(n, solve_ns=400_000, tail_ns=12_000):
    """n steps of the fleet's chunk, ns: K2, then the step tail."""
    ops, t = [], 0
    for _ in range(n):
        ops.append(("solve_tile_kernel", t, t + solve_ns))
        ops.append(("step_tail_kernel", t + solve_ns,
                    t + solve_ns + tail_ns))
        t += solve_ns + tail_ns
    return ops


@pytest.mark.parametrize("name", ("k2_roofline.fleet", "s2_us.fleet"))
def test_a_reader_gives_none_without_its_input(name):
    none = _run([], {}, 0)
    assert _read(name, none) is None
    untraced = _run([], {"solve_tile_kernel": 8, "step_tail_kernel": 8},
                    8 * 4096)
    assert _read(name, untraced) is None


def test_the_readers_read_the_window():
    """Eight fleet steps of 4096 live solves, K2 400 µs and S2 12 µs each;
    the trace keeps six of K2's launches: S2 reads 12 µs a launch (a step
    of the fleet, not a solve), K2's share is the bound of the live
    solves over the time of the launches kept, scaled to all."""
    ops = _steps(8)
    kept = [o for i, o in enumerate(ops)
            if o[0] != "solve_tile_kernel" or i >= 4]
    run = _run(kept, {"solve_tile_kernel": 8, "step_tail_kernel": 8},
               8 * 4096)
    assert _read("s2_us.fleet", run) == pytest.approx(12.0)
    bound, _ = roofline.solve_bound_s(run.cell.conf["mppi"], 8 * 4096)
    assert _read("k2_roofline.fleet", run) == pytest.approx(
        100.0 * bound * 6 / 8 / (6 * 400e-6))
    assert _read("k2_roofline.fleet", run) == _read("k2_roofline", run)
    assert 0 < _read("k2_roofline.fleet", run) < 100
