"""The port's spans (``mppi_robotarm_tpu_torch/utils/spans.py``): off by
default with no ring and no allocation, on under ``spans.recording()`` and
under a torch profiler, nesting with parents and roots, the ring's wrap
and the spans it dropped, ``between``, the profiler's clock, the named
spans of the CPU paths and of the graph paths (under the replaying
stand-in), ``capture_s`` from the ``graph.capture`` span's own reads, and
the spans in ``utils/timing.py::trace``'s Chrome trace.

Marked ``cuda`` and skipped without a card: the shared clock on the card,
each ``graph.replay`` span holding the ``cudaGraphLaunch`` the profiler
recorded for it.  It needs no JAX:

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda
"""

import bisect
import dataclasses
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.mppi import solver as psolver
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.utils import cuda_graphs, spans
from mppi_robotarm_tpu_torch.utils import timing as ptime
from _torch_port_helpers import (counted_kernels,  # noqa: F401 (fixtures)
                                 replaying_capture)

torch.set_num_threads(1)
ARM = P.ArmParams()
SIM = P.SimConfig()
FAR = 1 << 62


def _cfg(K=16, T=5):
    return dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T)


def _ref(device="cpu"):
    return torch.as_tensor(P.synth_circle_path(2000), dtype=torch.float32,
                           device=device)


def _x0(device="cpu"):
    return torch.tensor([1.1522, -1.2661, 0.0, 0.0], device=device)


@pytest.fixture(autouse=True)
def fresh_ring():
    spans.reset()
    yield
    spans.reset()


def recorded(lo=0, hi=FAR):
    return spans.between(lo, hi).spans


def names(spans_):
    return [s.name for s in spans_]


def _solves(calls, cfg=None, device="cpu"):
    cfg = cfg or _cfg()
    ref, x = _ref(device), _x0(device)
    state = P.init_state(cfg, device=device)
    for i in range(calls):
        res = P.solve(ARM, cfg, ref, x, state, backend="cuda", seed=3,
                      step=i)
        state = res.state
    return res


# ---- on and off ------------------------------------------------------------

def test_off_by_default_no_ring_and_no_allocation(monkeypatch):
    """1,000 solves with no profiler and no ``recording()``: the ring is
    never made and no span object is: every span is one of the two shared
    ones."""
    def made(*a):
        raise AssertionError("a span object was made")

    monkeypatch.setattr(spans, "_Recording", made)
    monkeypatch.setattr(spans, "_Clock", made)
    _solves(1000)
    assert not spans.allocated()
    assert spans.between(0, FAR) == spans.Recorded([], 0)
    with spans.span("solve") as s:
        assert not s
        with spans.span("solve.args") as inner:
            assert not inner
    assert not spans.allocated()


def test_on_under_recording_and_under_a_cpu_profiler():
    _solves(1)
    assert not spans.allocated()
    with spans.recording():
        _solves(1)
    assert names(recorded()) == ["init_state", "solve", "solve.args"]
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _solves(1)
    assert names(recorded()) == ["init_state", "solve", "solve.args"]
    n = len(recorded())
    _solves(1)                      # the profiler has stopped
    assert len(recorded()) == n


def test_nesting_parents_and_roots():
    with spans.recording():
        with spans.span("a") as a:
            with spans.span("b") as b:
                with spans.span("c") as c:
                    c.n = 7
            with spans.span("d"):
                pass
        with spans.span("e"):
            with spans.span("f"):
                pass
    assert a and b and c
    got = {s.name: s for s in recorded()}
    assert [(s.index, s.parent, s.root) for s in recorded()] == [
        (0, -1, 0), (1, 0, 0), (2, 1, 0), (3, 0, 0), (4, -1, 4), (5, 4, 4)]
    assert got["c"].n == 7 and got["a"].n == 0
    for inner, outer in (("b", "a"), ("c", "b"), ("d", "a"), ("f", "e")):
        assert got[outer].start <= got[inner].start <= got[inner].end \
            <= got[outer].end
    assert got["d"].start >= got["b"].end


def test_the_outermost_span_decides_for_the_call():
    """A call that opened without recording does not start recording half
    way, and one that opened recording keeps on after the switch is off."""
    with spans.span("off"):
        with spans.recording():
            with spans.span("inner") as s:
                assert not s
    assert not spans.allocated()
    with spans.recording():
        outer = spans.span("on")
        outer.__enter__()
    with spans.span("inner") as s:
        assert s
    outer.__exit__(None, None, None)
    assert names(recorded()) == ["on", "inner"]
    with spans.span("after") as s:
        assert not s


def test_a_raise_closes_the_span():
    with spans.recording():
        with pytest.raises(ValueError):
            with spans.span("a"):
                with spans.span("b"):
                    raise ValueError
        with spans.span("c"):
            pass
    assert [(s.name, s.parent) for s in recorded()] == [
        ("a", -1), ("b", 0), ("c", -1)]


def test_the_ring_wraps_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 8)
    with spans.recording():
        for i in range(20):
            with spans.span(f"s{i}") as s:
                s.n = i
    kept = spans.between(0, FAR)
    assert [s.n for s in kept.spans] == list(range(12, 20))
    assert kept.dropped == 12
    # a window after every dropped span lost nothing
    assert spans.between(kept.spans[0].start, FAR).dropped == 0
    assert spans.between(kept.spans[0].start - 10 ** 9, FAR).dropped == 12


def test_between_takes_the_spans_that_overlap():
    with spans.recording():
        for name in ("a", "b", "c"):
            with spans.span(name):
                time.sleep(0.002)
    a, b, c = recorded()
    assert names(recorded(b.start, b.end)) == ["b"]
    assert names(recorded(a.end, c.start)) == ["a", "b", "c"]
    assert names(recorded(a.end + 1, c.start - 1)) == ["b"]
    assert recorded(0, a.start - 1) == [] and recorded(c.end + 1, FAR) == []


def test_timed_reads_the_clock_either_way():
    with spans.timed("t") as t:
        time.sleep(0.002)
    assert not t and t.seconds >= 0.002 and not spans.allocated()
    with spans.recording():
        with spans.timed("t") as t:
            pass
    (s,) = recorded()
    assert t and t.seconds == (s.end - s.start) * 1e-9


def test_spans_share_the_profilers_clock():
    """A ``record_function`` marker inside a span starts and ends, by the
    profiler's own stamps, within 1 ms of the span's bounds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with spans.span("outer"):
                with record_function("mark"):
                    torch.ones(16).sum()
    got = recorded()
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "mark")
    assert len(got) == len(marks) == 5
    for s, (m0, m1) in zip(got, marks):
        assert s.start - 1_000_000 <= m0 <= m1 <= s.end + 1_000_000


# ---- the named spans of the port's paths ------------------------------------

def test_the_cpu_entry_points_emit_their_spans():
    cfg, ref = _cfg(), _ref()
    with spans.recording():
        st = P.init_sim(cfg, SIM, seed=4, device="cpu")
        P.simulate(ARM, cfg, SIM, ref, st, 3, backend="cuda")
        P.simulate_fused(ARM, cfg, SIM, ref, st, 3)
        sb = P.init_sim_batch(cfg, SIM, [1, 2], device="cpu")
        P.simulate_fused_batch(ARM, cfg, SIM, ref, sb, 2)
        P.simulate_batch(ARM, cfg, SIM, ref, sb, 2)
        x = torch.stack([_x0(), _x0()])
        P.solve_batched(ARM, cfg, ref, x, sb.mppi, seeds=sb.seed,
                        step=sb.step)
        res = P.solve(ARM, cfg, ref, _x0(), st.mppi, backend="cuda", seed=1,
                      want_eps=True)
        P.viz_rollouts(ARM, cfg, _x0(), res.u_seq, st.mppi.u_prev, res.eps,
                       res.costs)
    roots = [(s.name, [c.name for c in recorded() if c.parent == s.index])
             for s in recorded() if s.parent == -1]
    fused = ["fused.inputs", "fused.launch", "fused.records"]
    assert roots == [("init_sim", ["init_state"]), ("simulate", []),
                     ("simulate_fused", fused), ("init_sim", []),
                     ("simulate_fused", fused), ("simulate", []),
                     ("solve_batched", []), ("solve", ["solve.args"]),
                     ("viz_rollouts", [])]
    for s in recorded():
        assert s.root == (s.index if s.parent == -1 else s.parent)


@pytest.fixture
def call_graphs_on_cpu(replaying_capture, counted_kernels):  # noqa: F811
    """The captured programs on CPU tensors under the replaying stand-in,
    the cuda backend's kernels counted as on the card."""


def test_the_per_call_graph_emits_its_spans(call_graphs_on_cpu):
    """First call warm, second captured, copied in and replayed, third
    copied in and replayed; each hands back its result through
    ``graph.clone_out``; ``graph.copy_in`` counts the bytes of every
    input it stages: x, u_prev, wp_idx, and seed and step through the
    pinned buffer; the path is read where it lies."""
    with spans.recording():
        _solves(3)
    calls = [[c.name for c in recorded() if c.root == s.index
              and c.index != s.index] for s in recorded()
             if s.name == "solve"]
    assert calls == [
        ["solve.args", "graph.key", "graph.warm", "graph.clone_out"],
        ["solve.args", "graph.key", "graph.capture", "graph.copy_in",
         "graph.replay", "graph.clone_out"],
        ["solve.args", "graph.key", "graph.copy_in", "graph.replay",
         "graph.clone_out"]]
    copies = [s.n for s in recorded() if s.name == "graph.copy_in"]
    assert copies == [4 * 4 + 5 * 2 * 4 + 3 * 8] * 2


def test_a_per_call_replay_copies_440_bytes(call_graphs_on_cpu):
    """A real-time caller's replay at T = 50 stages 440 B: the
    observation (16), u_prev (400), the waypoint index (8), and seed and
    step (16) through the pinned buffer; the path none."""
    with spans.recording():
        _solves(4, _cfg(16, 50))
    copies = [s.n for s in recorded() if s.name == "graph.copy_in"]
    assert copies == [440] * 3


def test_capture_seconds_are_the_capture_spans(call_graphs_on_cpu):
    with spans.recording():
        _solves(2)
    (g,) = psolver._CALL_GRAPHS.values()
    (s,) = [s for s in recorded() if s.name == "graph.capture"]
    assert g.captured.capture_s == (s.end - s.start) * 1e-9
    spans.reset()
    psolver._CALL_GRAPHS.clear()
    _solves(2)                                  # not recording
    (g,) = psolver._CALL_GRAPHS.values()
    assert g.captured.capture_s > 0 and not spans.allocated()


def _loop_spans(run) -> list:
    """The spans directly under the ``simulate`` root of ``run()``."""
    spans.reset()
    with spans.recording():
        with spans.span("simulate"):
            run()
    return [s for s in recorded() if s.parent == 0]


def test_the_step_loop_emits_its_chunk_spans(replaying_capture,  # noqa: F811
                                             monkeypatch):
    """Three runs in chunks of 4 over 10 steps (the eager backend's, whose
    capture the stand-in takes on the CPU).  The first runs each chunk
    length's first chunk warm and captures the 4-step chunk at its
    second; the second captures the 2-step chunk; the third replays all.
    A run copies its state, clock and path in at its first replay and at
    each change of graph, not into the graph the last replay left them
    in; every chunk copies its rows out, then the final state is cloned
    out."""
    monkeypatch.setattr(ploop, "_EAGER_GRAPH_STEPS", 4)
    cfg, ref = _cfg(), _ref()
    st = ploop._as_batch(P.init_sim(cfg, SIM, seed=4, device="cpu"))
    run = lambda: ploop._step_loop(ARM, cfg, SIM, ref, st, 10,
                                   backend="eager")
    key, out = "graph.key", "loop.rows_out"
    warm = [key, "graph.warm", out]
    capture = [key, "graph.capture", "graph.copy_in", "graph.replay", out]
    copy = [key, "graph.copy_in", "graph.replay", out]
    replay = [key, "graph.replay", out]
    state_bytes = sum(v.nbytes for v in ploop._state_tensors(
        st._replace(seed=torch.as_tensor(st.seed))))
    per_step = sum(r.nbytes for r in ploop._row_buffers(1, st, ref))
    for want in ([*warm, *capture, *warm], [*copy, *replay, *capture],
                 [*copy, *replay, *copy]):
        got = _loop_spans(run)
        assert names(got) == [*want, "loop.state_out"]
        copies = [s.n for s in got if s.name == "graph.copy_in"]
        assert copies == [state_bytes + 8 + ref.nbytes] * want.count(
            "graph.copy_in")
        rows = [s.n for s in got if s.name == out]
        assert rows == [4 * per_step, 4 * per_step, 2 * per_step]


def test_a_continuing_chunk_copies_nothing_in(call_graphs_on_cpu,
                                              monkeypatch):
    """A run at B = 1 of three chunks of one graph (the cuda backend's, in
    chunks of 4): once captured, its first chunk copies the state, clock
    and path in, and the two after it replay on what the last replay
    left, copying nothing; the records are the uncaptured loop's."""
    monkeypatch.setattr(ploop, "_GRAPH_STEPS", 4)
    cfg, ref = _cfg(), _ref()
    st = P.init_sim(cfg, SIM, seed=4, device="cpu")
    run = lambda: P.simulate(ARM, cfg, SIM, ref, st, 12, backend="cuda")
    run()                                       # warm, then captured
    with cuda_graphs.uncaptured():
        want = run()
    spans.reset()
    with spans.recording():
        got = run()
    assert [s.name for s in recorded()].count("graph.copy_in") == 1
    assert [s.name for s in recorded()].count("graph.replay") == 3
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_the_trace_holds_the_spans_on_its_time_base(tmp_path):
    """``--profile-dir``'s trace: each solve's span is a complete event on
    a row of its own, around the profiler's own events of that solve."""
    log_dir = str(tmp_path / "prof")
    with ptime.trace(log_dir):
        _solves(2)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "port_span"]
    assert [e["name"] for e in ours] == [
        "init_state", "solve", "solve.args", "solve", "solve.args"]
    assert {e["tid"] for e in ours} == {ptime.SPANS_TID}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    for s in (e for e in ours if e["name"] == "solve"):
        inside = [e for e in ops if s["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        assert inside, s


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs replay on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replay_spans_hold_their_graph_launch_on_the_card(dev):
    """1,200 solves under the profiler with CUDA activity alone, as the
    benchmark traces: at least 99 % of the ``graph.replay`` spans contain
    a ``cudaGraphLaunch`` runtime event of the same trace."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=1024, horizon=50)
    _solves(3, cfg, dev)                    # warm, captured, replayed
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _solves(1200, cfg, dev)
        torch.cuda.synchronize(dev)
    launches = sorted(e.start_ns() for e in
                      prof.profiler.kineto_results.events()
                      if e.name() == "cudaGraphLaunch")
    replays = [s for s in recorded() if s.name == "graph.replay"]
    assert len(replays) == 1200 and len(launches) >= 1200
    held = sum(1 for s in replays
               if bisect.bisect_right(launches, s.end)
               > bisect.bisect_left(launches, s.start))
    assert held >= 0.99 * len(replays), (held, len(replays))
