"""The readers of the port's spans (``portbench/spans.py`` and the five
metrics that read it) on a synthetic trace and synthetic spans: the idle
gaps put down to the innermost span, to the root of their call and to
the caller, adding up to the trace's idle time; spans clipped to the
window; and no value where the ring dropped spans in the window or the
program records none."""

import pytest

from mppi_robotarm_tpu_torch.utils import spans as program_spans
from portbench import harness, spans
from portbench.chains import Window
from portbench.trace import Trace

ROOT = harness.ROOT
COPY = 128_000 + 16 + 400 + 3 * 8     # the path, x, u_prev, wp, seed, step


def S(index, name, start, end, parent=-1, root=None, n=0):
    return program_spans.Span(index, name, start, end, parent,
                              index if root is None else root, n)


# a window of [0, 1000] ns, the device busy over [100, 150] and [400, 450]
TRACE = Trace([("step_head_kernel", 100, 150), ("solve_tile_kernel", 400,
                                                  450)], (0, 1000))
# two solve calls: the first with its whole path, the second copying in
CALLS = [S(0, "solve", 50, 300), S(1, "solve.args", 50, 80, 0, 0),
         S(2, "graph.key", 80, 90, 0, 0),
         S(3, "graph.copy_in", 90, 120, 0, 0, COPY),
         S(4, "graph.replay", 120, 140, 0, 0),
         S(5, "graph.clone_out", 140, 200, 0, 0),
         S(6, "solve", 500, 700), S(7, "graph.copy_in", 520, 560, 6, 6, COPY)]


@pytest.fixture
def program(monkeypatch):
    """The program's ``between`` answering with given spans and drops."""
    def give(recorded, dropped=0):
        monkeypatch.setattr(program_spans, "between",
                            lambda lo, hi: program_spans.Recorded(
                                [s for s in recorded if s.start <= hi
                                 and s.end >= lo], dropped))
    return give


def run_of(trace, calls=2, solves=2):
    return harness.Run(None, Window(0.0, 1.0, solves, solves, calls, [], {},
                                    {}), Trace(list(trace.ops), trace.span),
                       0.0, 0)


def read(name, run):
    return harness.load(ROOT, "metrics", name).read(run)


def test_idle_goes_to_the_innermost_span_or_outside(program):
    program(CALLS)
    laid = spans.of_run(run_of(TRACE))
    assert laid.idle == {spans.OUTSIDE: 500, "solve.args": 30,
                         "graph.key": 10, "graph.copy_in": 50,
                         "graph.clone_out": 50, "solve": 260}
    assert laid.idle_by_root == {spans.OUTSIDE: 500, "solve": 400}
    assert laid.idle_ns == sum(laid.idle.values()) == 900
    assert laid.idle_ns == pytest.approx(
        (TRACE.window_s - TRACE.busy_s) * 1e9)
    assert laid.held["solve"] == 450 and laid.held["graph.copy_in"] == 70
    t = spans.table(laid, TRACE)
    assert t["laid_over_idle"] == pytest.approx(1.0)
    assert list(t["idle_by_span"])[0] == spans.OUTSIDE


def test_the_solve_readers(program):
    program(CALLS)
    run = run_of(TRACE)
    assert read("solve_host_us", run) == pytest.approx((250 + 200) / 2e3)
    assert read("solve_idle_us", run) == pytest.approx(400 / 2e3)
    assert read("solve_copy_in_kib", run) == pytest.approx(125.4296875)
    assert read("solve_idle_us", run) <= read("host_us_per_call", run)
    # no simulate call in the window: nothing to read
    assert read("steploop_host_idle_us", run) is None
    assert read("fused_host_idle_us", run) is None


def test_the_loop_readers_and_clipping(program):
    """A chain that began before the window counts from its start; a gap
    under a chunk's replay goes to the simulate call."""
    program([S(0, "simulate", -500, 600), S(1, "graph.replay", 150, 400, 0,
                                            0),
             S(2, "simulate_fused", 700, 900),
             S(3, "fused.launch", 720, 800, 2, 2)])
    run = run_of(TRACE, calls=4, solves=10)
    laid = spans.of_run(run)
    assert laid.spans[0].start == 0 and laid.held["simulate"] == 600
    assert laid.idle_by_root == {"simulate": 100 + 250 + 150,
                                 "simulate_fused": 200,
                                 spans.OUTSIDE: 100 + 100}
    assert laid.idle["graph.replay"] == 250
    assert read("steploop_host_idle_us", run) == pytest.approx(500 / 10e3)
    assert read("fused_host_idle_us", run) == pytest.approx(200 / 4e3)
    assert read("solve_idle_us", run) is None


@pytest.mark.parametrize("name", ["solve_host_us", "solve_idle_us",
                                  "solve_copy_in_kib",
                                  "steploop_host_idle_us",
                                  "fused_host_idle_us"])
def test_nothing_is_read_where_the_ring_dropped_or_there_are_no_spans(
        program, monkeypatch, name):
    program(CALLS + [S(8, "simulate", 710, 720),
                     S(9, "simulate_fused", 730, 740)], dropped=3)
    assert read(name, run_of(TRACE)) is None
    program(CALLS + [S(8, "simulate", 710, 720),
                     S(9, "simulate_fused", 730, 740)])
    assert read(name, run_of(TRACE)) is not None
    monkeypatch.setattr(spans, "PROGRAM_SPANS", "no_such_module.spans")
    assert read(name, run_of(TRACE)) is None


def test_spans_that_touch_and_nest_at_one_instant(program):
    """Siblings end to end, a child sharing its parent's bounds, a span of
    no length: each instant goes to the innermost span once."""
    program([S(0, "solve", 0, 1000), S(1, "a", 0, 100, 0, 0),
             S(2, "b", 100, 400, 0, 0), S(3, "c", 100, 400, 2, 0),
             S(4, "d", 450, 450, 0, 0)])
    laid = spans.of_run(run_of(TRACE))
    assert laid.idle == {"a": 100, "c": 250, "solve": 550}
    assert laid.idle_by_root == {"solve": 900}
