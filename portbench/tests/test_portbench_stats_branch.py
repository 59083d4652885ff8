"""The large-K cell's readers of the step tail's statistics launched on
their own (``step_stats_kernel``, on a branch beside the next solve):
their device µs a live solve and their overlap with the solve, on a made
trace; nothing where the program has no such launch (the parent's)."""

import types

import pytest

from mppi_robotarm_tpu_torch.ops import cuda_step
from portbench import harness, program
from portbench.trace import Trace

NAME = "largek_k65536_h50.steploop"
READERS = ("s2_stats_us.largek", "s2_stats_overlap.largek")


def _run(ops, counters, solves):
    window = types.SimpleNamespace(
        counters={**{k: 0 for k in program.counters()}, **counters},
        solves=solves)
    span = (0, max((b for _, _, b in ops), default=0))
    return harness.Run(harness.load_cell(NAME), window, Trace(ops, span),
                       1.0, 0)


def _read(name, run):
    return harness.load(harness.ROOT, "metrics", name).read(run)


def _steps(n, stats_ns=80, solve_ns=100, tail_ns=3):
    """n steps of a branched chunk, ns: K2, the control tail, then the
    statistics from the control tail's end, the next K2 beside them."""
    ops, t = [], 0
    for _ in range(n):
        ops.append(("solve_tile_kernel", t, t + solve_ns))
        ops.append(("step_tail_kernel", t + solve_ns,
                    t + solve_ns + tail_ns))
        t += solve_ns + tail_ns
        ops.append(("step_stats_kernel", t, t + stats_ns))
    return sorted(ops, key=lambda o: o[1])


@pytest.mark.parametrize("name", READERS)
def test_a_statistics_reader_reads_nothing_without_the_launch(
        name, monkeypatch):
    """A trace with no statistics launch, or a program that counts none,
    gives no reading, and raises nothing."""
    ops = [o for o in _steps(4) if o[0] != "step_stats_kernel"]
    run = _run(ops, {"solve_tile_kernel": 4, "step_tail_kernel": 4}, 4)
    assert _read(name, run) is None
    if name == "s2_stats_us.largek":
        monkeypatch.delattr(cuda_step, "STATS_LAUNCHES")
        run = _run(_steps(4), {"solve_tile_kernel": 4,
                               "step_tail_kernel": 4}, 4)
        assert _read(name, run) is None


def test_the_statistics_readers_read_the_window(monkeypatch):
    """Four steps whose statistics, 80 ns each, run beside the next K2 but
    the last: 80 ns a live solve (seen at each launch, one a tail), 75 %
    of it beside a solve."""
    monkeypatch.setattr(cuda_step, "STATS_LAUNCHES", 32)
    monkeypatch.setattr(cuda_step, "TAIL_LAUNCHES", 32)
    run = _run(_steps(4), {"solve_tile_kernel": 4,
                           "step_tail_kernel": 4}, 4)
    assert _read("s2_stats_us.largek", run) == pytest.approx(80e-3)
    assert _read("s2_stats_overlap.largek", run) == pytest.approx(75.0)
    # half the launches dropped by the trace, half the tails branched
    kept = [o for i, o in enumerate(_steps(4))
            if o[0] != "step_stats_kernel" or i % 2]
    monkeypatch.setattr(cuda_step, "STATS_LAUNCHES", 16)
    seen = sum(o[0] == "step_stats_kernel" for o in kept)
    run = _run(kept, {"solve_tile_kernel": 4, "step_tail_kernel": 4}, 4)
    assert seen and _read("s2_stats_us.largek", run) == pytest.approx(40e-3)
