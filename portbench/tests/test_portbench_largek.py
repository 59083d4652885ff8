"""The large-K cell (``largek_k65536_h50.steploop``, BASELINE config 3 at
K=65536) on the CPU: the cell's own file at K=4096 through a whole run of
the harness, the layouts its ``why`` names, the check's faults and control
at the size the other cells take here, and its three readers.  On a card,
the control at the cell's own size."""

import copy
import time
import types

import pytest
import torch

import test_portbench_faults as faults
from mppi_robotarm_tpu_torch.ops import cuda_solve, cuda_step
from portbench import harness, judge, program, roofline

NAME = "largek_k65536_h50.steploop"
SEED = 2 ** 33 + 17


def _cell(K: int, **traffic):
    """The cell at K samples on a 400-row path, every other setting its
    file's."""
    cell = harness.load_cell(NAME)
    conf = copy.deepcopy(cell.conf)
    conf["mppi"]["num_samples"] = K
    conf["path"]["waypoints"] = 400
    return cell._replace(conf=conf, traffic={**cell.traffic, **traffic})


def _measure(cell):
    return harness.measure(cell, SEED, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a: None)


def test_the_cell_at_k4096_is_correct():
    """K=4096, H=50: 128 tiles of 32 a solve, so the combine folds the
    cell's 128 partials, and above 1024 samples the step tail's
    statistics take the cap-0 order; both round as at K=65536 in kind."""
    cell = _cell(4096, chain_steps=4, check_from=3)
    _, cfg, _ = program.configs(cell.conf)
    assert cfg.horizon == 50
    assert cuda_solve._plan(cfg, 4096, None, True, True)[:2] == (32, 128)
    assert cuda_step.step_tail_layout(4096, 1).cap == 0
    out = _measure(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_the_layouts_the_cells_why_names():
    """On the H100 (132 SMs, 15 slots for the step tail's cluster of 8)
    K=65536 is 128 tiles of 512 samples at one lane a sample and one tile
    a block, which leave the SMs the statistics' one block takes, so the
    step loop splits the tail: the control warp alone between two K2s,
    the statistics beside the next K2 in one block of 16 warps of two
    logical lanes a lane, reading S each pass, and a chunk's last
    statistics on a cluster of 8 CTAs, their samples kept on chip."""
    _, cfg, _ = program.configs(harness.load_cell(NAME).conf)
    assert cfg.num_samples == 65536 and cfg.horizon == 50
    sms, slots = 132, 15
    assert cuda_solve.solve_layout(cfg, 65536, 1, sms) == (512, 1, 1)
    plan = cuda_solve._plan(cfg, 65536, None, True, True, 1, sms)
    assert plan == (512, 128, 1, 1)
    assert cuda_step.stats_branch(65536, 1, sms, plan)
    assert cuda_step.CONTROL_LAYOUT == cuda_step.TailLayout(0, 2, 1, 0)
    beside = cuda_step.step_tail_layout(65536, 1, sms)
    assert beside == cuda_step.TailLayout(16, 2, 1, 0)
    last = cuda_step.step_tail_layout(65536, 1, sms, slots)
    assert last == cuda_step.TailLayout(4, 1, 1, 64, cuda_step.TAIL_CLUSTER)
    assert (last.lanes, last.cap) == cuda_step.CLUSTER_BUILD
    for layout in (cuda_step.CONTROL_LAYOUT, beside, last):
        assert cuda_step.tail_layout_fits(layout)
    assert cuda_step.tail_layout_fits(beside, 65536)
    assert cuda_step.tail_layout_fits(last, 65536)
    tile, n_tiles, _, group = plan
    assert cuda_solve.solve_smem_bytes(cfg, tile, n_tiles, group) == 208200


def _tiny():
    """The cell at the size the other cells' checks take on the CPU
    (``test_portbench_faults.tiny``): K=16, T=6 on a 400-row path."""
    cell = _cell(16, chain_steps=30, check_from=4)
    cell.conf["mppi"]["horizon"] = 6
    return cell


def test_a_sound_run_is_correct():
    out = _measure(_tiny())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [faults._unchanged, faults._half_samples,
                                   faults._altered],
                         ids=lambda f: f.__name__[1:])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch, "arm_k1024_h50.steploop")     # the step loop's
    out = _measure(_tiny())
    assert not out["correct"], out["checks"]


def _control(cell, seconds, device, seeds):
    from portbench import control

    driver = harness.load(cell.root, "drivers", cell.traffic["driver"])
    return [control.seed_readings(cell, driver, s, seconds, device, True)
            for s in seeds]


def test_the_bfloat16_control_is_not_correct():
    cell = _tiny()
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


# ---- the cell's readers ----------------------------------------------------

class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel(self, name):
        return self.kernels.get(name, (0.0, 0))


def _run(kernels, counters, solves):
    cell = harness.load_cell(NAME)
    window = types.SimpleNamespace(counters=counters, solves=solves)
    return harness.Run(cell, window, _Trace(kernels), 1.0, 0)


READERS = ("k2_roofline.largek", "s2_us.largek", "k2_partials")


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_without_its_input(name, monkeypatch):
    """No launch in the window, or none in the trace, or (the parent's
    program) no partials count: no reading."""
    monkeypatch.delattr(cuda_solve, "PARTIALS")
    read = harness.load(harness.ROOT, "metrics", name).read
    none = {k: 0 for k in program.counters()}
    assert read(_run({}, none, 0)) is None
    launched = {**none, "solve_tile_kernel": 40, "step_tail_kernel": 40}
    assert read(_run({}, launched, 40)) is None
    if name == "k2_partials":
        assert read(_run({"solve_tile_kernel": (1e-3, 40)}, launched,
                         40)) is None


def test_the_readers_read_the_window(monkeypatch):
    """4000 live solves: K2 and S2 seen at 3000 of their 4000 launches,
    and the window's 512,000 partials, 128 a launch; the process's own
    count (1280 partials over 10 launches, 128 too) is not what is read."""
    monkeypatch.setattr(cuda_solve, "LAUNCHES", 10)
    monkeypatch.setattr(cuda_solve, "PARTIALS", 1280)
    counters = {**{k: 0 for k in program.counters()},
                "solve_tile_kernel": 4000, "step_tail_kernel": 4000,
                "solve_partials": 4000 * 128}
    run = _run({"solve_tile_kernel": (0.3, 3000),
                "step_tail_kernel": (0.015, 3000)}, counters, 4000)
    load = lambda n: harness.load(harness.ROOT, "metrics", n).read(run)
    assert load("k2_partials") == pytest.approx(128.0)
    assert load("s2_us.largek") == pytest.approx(5.0)
    bound, _ = roofline.solve_bound_s(run.cell.conf["mppi"], 4000)
    assert load("k2_roofline.largek") == pytest.approx(
        100.0 * bound * 0.75 / 0.3)
    assert load("k2_roofline.largek") == load("k2_roofline")
    monkeypatch.setattr(cuda_solve, "PARTIALS", 2560)
    assert load("k2_partials") == pytest.approx(128.0)
    run.window.counters["solve_partials"] = 4000 * 64
    assert load("k2_partials") == pytest.approx(64.0)


def test_the_window_counts_its_own_partials(monkeypatch):
    """``program.counters`` names the port's partials count beside the
    launches, and leaves it out where the port has none."""
    monkeypatch.setattr(cuda_solve, "PARTIALS", 77)
    assert program.counters()["solve_partials"] == 77
    monkeypatch.delattr(cuda_solve, "PARTIALS")
    assert "solve_partials" not in program.counters()
