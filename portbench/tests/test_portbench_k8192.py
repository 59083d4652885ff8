"""The cell at the bottom of config 3 (``largek_k8192_h50.steploop``, K=8192,
H=50) on the CPU: its configuration against config 3's other file, the
layouts its ``why`` names, the cell's own file at K=8192 through a whole
run of the harness, the check's faults and control at the size the other
cells take here, and its readers.  On a card, the control at the cell's
own size and the launch counts of the layouts the ``why`` names."""

import copy

import pytest
import torch

import test_portbench_faults as faults
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step
from portbench import harness, judge, program
from test_portbench_fleet_steploop import window_counts
from test_portbench_largek import _control, _measure
from test_portbench_stats_branch import _read, _run, _steps

NAME = "largek_k8192_h50.steploop"
TOP = "largek_k65536_h50.steploop"
SEED = 2 ** 33 + 17


def test_the_configuration_is_config_3s_other_file_at_k8192():
    """Every setting the run reads is the K=65536 file's but the sample
    count; the traffic and the limits' readings are the step loop's."""
    cell, top = harness.load_cell(NAME), harness.load_cell(TOP)
    assert cell.conf["mppi"] == {**top.conf["mppi"], "num_samples": 8192}
    for k in ("arm", "sim", "path", "dtype", "reduced", "guarantees"):
        assert cell.conf[k] == top.conf[k], k
    assert cell.conf["source"] != top.conf["source"]
    assert cell.traffic == top.traffic and cell.chips == 1
    assert set(cell.limits) == set(top.limits)
    assert [m["name"] for m in cell.end_to_end] == ["solves_per_s",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "k2_roofline.k8192", "s2_stats_us.k8192", "s2_stats_overlap.k8192",
        "device_idle", "solve_mfu"}


def test_the_layouts_the_cells_why_names():
    """On the H100 (132 SMs, 15 slots for the step tail's cluster of 8)
    K=8192 is 128 tiles of 64 samples at two lanes a sample, one tile a
    block, so the window scan keeps its loop; the blocks leave the SMs
    the statistics' one block takes, so the loop splits the tail: the
    control warp alone between two K2s, the statistics in one block of 16
    warps of two logical lanes a lane that read S each pass (cap 0),
    beside K2 and, eight samples a logical lane being too few for a wave
    of clusters, as a chunk's last alike."""
    _, cfg, _ = program.configs(harness.load_cell(NAME).conf)
    assert cfg.num_samples == 8192 and cfg.horizon == 50
    sms, slots = 132, 15
    plan = cuda_solve._plan(cfg, 8192, None, True, True, 1, sms)
    assert plan == (64, 128, 2, 1)
    assert cuda_sim.scan_width(cfg.search_idx_len, plan[2]) == 0
    assert cuda_step.stats_branch(8192, 1, sms, plan)
    one_block = cuda_step.TailLayout(16, 2, 1, 0)
    for s in (0, slots):
        assert cuda_step.step_tail_layout(8192, 1, sms, s) == one_block
    assert cuda_step.tail_layout_fits(one_block, 8192)
    assert cuda_step.tail_layout_fits(cuda_step.CONTROL_LAYOUT)


def _cell(K: int, H: int, waypoints: int = 400, **traffic):
    cell = harness.load_cell(NAME)
    conf = copy.deepcopy(cell.conf)
    conf["mppi"].update(num_samples=K, horizon=H)
    conf["path"]["waypoints"] = waypoints
    return cell._replace(conf=conf, traffic={**cell.traffic, **traffic})


def test_the_cell_at_its_own_k_is_correct():
    """K=8192, H=50 on the cell's 8000-row path, in chains of 3 steps:
    the statistics take the cap-0 order of above 1024 samples, as on the
    card."""
    out = _measure(_cell(8192, 50, 8000, chain_steps=3, check_from=3))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _tiny():
    """K=16, T=6 on a 400-row path (``test_portbench_faults.tiny``'s
    size)."""
    return _cell(16, 6, chain_steps=30, check_from=4)


def test_a_sound_run_is_correct():
    out = _measure(_tiny())
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [faults._unchanged, faults._half_samples,
                                   faults._altered],
                         ids=lambda f: f.__name__[1:])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch, "arm_k1024_h50.steploop")     # the step loop's
    out = _measure(_tiny())
    assert not out["correct"], out["checks"]


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
    for o in _control(cell, 8.0, torch.device("cuda", 0),
                      [11, 2 ** 31 + 3, 2 ** 40 + 5]):
        assert judge.verdict(o["program"], cell.limits)[0], o
        assert not judge.verdict(o["control"], cell.limits)[0], o


@pytest.mark.cuda
def test_the_counts_confirm_the_layouts_on_the_card():
    """Each step's statistics ran on their own, none on a cluster, and no
    solve took the compiled-width scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size on the card")
    n = window_counts(NAME, 1.0)
    assert n["LAUNCHES"] == n["calls"] * 4000 > 0, n
    assert n["TAIL_LAUNCHES"] == n["STATS_LAUNCHES"] == n["LAUNCHES"], n
    assert n["CLUSTER_TAILS"] == 0 and n["COMPILED_SCANS"] == 0, n


# ---- the cell's readers ----------------------------------------------------

@pytest.mark.parametrize("name", ("k2_roofline.k8192", "s2_stats_us.k8192",
                                  "s2_stats_overlap.k8192"))
def test_a_reader_reads_as_its_large_k_twin(name, monkeypatch):
    """The cell's readers are the large-K cell's arithmetic: the same
    reading on the same made window, and none on an empty one."""
    monkeypatch.setattr(cuda_step, "STATS_LAUNCHES", 32)
    monkeypatch.setattr(cuda_step, "TAIL_LAUNCHES", 32)
    twin = name.replace("k8192", "largek")
    run = _run(_steps(4), {"solve_tile_kernel": 4, "step_tail_kernel": 4}, 4)
    assert _read(name, run) == _read(twin, run) is not None
    assert _read(name, _run([], {}, 0)) is None
