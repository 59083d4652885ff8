"""The cuda backend's per-step loop (``sim/loop.py::_step_loop``): chunks
of ``_GRAPH_STEPS`` steps, each writing its record rows into buffers in
place, run eagerly on the CPU and in eps mode and as replayed CUDA graphs
on the card.

On the CPU (the solves through the solve kernel's plain twin): the chunked
loop against :func:`list_loop`, a copy of the loop it replaced, which
appended each step's rows to a list and stacked them after the loop.
Records and final state must be equal bit for bit: the two run the same
operations in the same order.  The chunk boundaries are moved with a small
``_GRAPH_STEPS``; one case runs the package's own.

Under the replaying stand-in (``_torch_port_helpers.py::
replaying_capture``): a new key's first chunk runs uncaptured, with the
graph loop's bits, and the tails a chunk ran on a cluster are held to its
key's tail layout.  The cases the loop's chunks share with the per-call
graphs (keys, launches and partials a replay adds, the raise on other
launches) are in ``tests/test_torch_call_graphs.py``.

Marked ``cuda`` and skipped without a card: the graph loop against the
uncaptured chunked loop bit for bit (K=1024 B=1, K=128 B=64, a path end
inside a chunk), the graph cache, two streams, the launch count, and a
change of the solve's layout.  The file imports nothing of JAX, so on a
GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_steploop.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.models.arm import fk_full
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.ops.weights import (effective_sample_size,
                                                 weight_entropy)
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.utils import cuda_graphs
from _torch_port_helpers import (counted_kernels,  # noqa: F401 (fixtures)
                                 replaying_capture)

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()
SMALL_S = 4          # chunk length of the CPU cases


def list_loop(arm, cfg, sim, ref_path, states0, num_steps, eps_per_step=None):
    """The cuda backend's loop before the chunks: a list of each step's
    rows, stacked after the loop."""
    device = states0.q.device
    states = states0._replace(seed=torch.as_tensor(
        states0.seed, dtype=torch.int64, device=device))
    rows = []
    for i in range(num_steps):
        eps = None if eps_per_step is None else eps_per_step[i]
        states, res = ploop._step_batch(arm, cfg, sim, ref_path, states, eps)
        rows.append((states.q, states.dq, res.u0, states.mppi.wp_idx,
                     torch.amin(res.costs, dim=-1),
                     torch.mean(res.costs, dim=-1),
                     effective_sample_size(res.weights),
                     weight_entropy(res.weights), states.done))
    q, dq, u, wp, cmin, cmean, ess, ent, done = (
        torch.stack(f) for f in zip(*rows))
    x1, y1, x2, y2 = fk_full(q[..., 0], q[..., 1], arm)
    idx = torch.clamp(states0.step.to(device)
                      + torch.arange(1, num_steps + 1, device=device)[:, None],
                      max=ref_path.shape[0] - 1)
    zero = lambda v: torch.where(done.view(*done.shape, *(1,) * (v.dim() - 2)),
                                 torch.zeros_like(v), v)
    return states._replace(seed=states0.seed), P.SimRecord(
        q=q, dq=dq, u=zero(u), ee=torch.stack([x2, y2], dim=-1),
        elbow=torch.stack([x1, y1], dim=-1), ref_xy=ref_path[idx, 0:2],
        wp_idx=wp, cost_min=zero(cmin), cost_mean=zero(cmean), ess=zero(ess),
        weight_entropy=zero(ent), done=done)


def assert_same_run(got, want):
    """Two (final state, record) results equal bit for bit."""
    (fg, rg), (fw, rw) = got, want
    for f, a, b in zip(rg._fields, rg, rw):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for a, b in zip((fg.step, fg.q, fg.dq, *fg.mppi, fg.done),
                    (fw.step, fw.q, fw.dq, *fw.mppi, fw.done)):
        assert torch.equal(a, b)
    assert torch.equal(torch.as_tensor(fg.seed), torch.as_tensor(fw.seed))


def _cfg(K=32, T=6):
    return dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T)


def _ref(rows=2000, device="cpu"):
    return torch.as_tensor(P.synth_circle_path(rows), dtype=torch.float32,
                           device=device)


def _batch(cfg, B, device="cpu", wp0=None):
    q0 = (np.array([SIM.q0]) + 0.01 * np.random.default_rng(B).normal(
        size=(B, 2))).astype(np.float32)
    st = P.init_sim_batch(cfg, SIM, np.arange(B) * 7 + 1, q0=q0,
                          device=device)
    if wp0 is not None:
        st = st._replace(mppi=st.mppi._replace(wp_idx=torch.as_tensor(
            wp0, dtype=torch.int64, device=device)))
    return st


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(ploop, "_GRAPH_STEPS", SMALL_S)


@pytest.mark.parametrize("steps", [SMALL_S - 1, SMALL_S, 2 * SMALL_S + 3])
@pytest.mark.parametrize("B", [1, 3])
def test_chunked_loop_equals_list_loop(small_chunks, steps, B):
    """Fewer steps than a chunk, one chunk, and a ragged last chunk; B = 1
    through ``simulate``, B = 3 through ``simulate_batch``."""
    cfg, ref = _cfg(), _ref()
    states = _batch(cfg, B)
    want = list_loop(ARM, cfg, SIM, ref, states, steps)
    if B == 1:
        s0 = ploop._scenario(states, 0, int(states.seed[0]))
        final, rec = P.simulate(ARM, cfg, SIM, ref, s0, steps,
                                backend="cuda")
        got = (ploop._as_batch(final),
               P.SimRecord(*(f[:, None] for f in rec)))
        assert got[0].seed.tolist() == [int(states.seed[0])]
        got = (got[0]._replace(seed=want[0].seed), got[1])
    else:
        got = P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                               backend="cuda")
    assert_same_run(got, want)
    assert not ploop._GRAPHS         # CPU tensors never capture


def test_chunked_loop_path_end_inside_a_chunk(small_chunks):
    """Scenarios freeze at the path end at steps that are not a chunk's
    first: the frozen rows and the final state are the list loop's."""
    cfg = _cfg()
    ref = torch.as_tensor(P.synth_circle_path(40, revolutions=0.02),
                          dtype=torch.float32)
    states = _batch(cfg, 3, wp0=[0, 5, 10])
    steps = 15 * SMALL_S + 1         # they freeze near steps 49-59
    want = list_loop(ARM, cfg, SIM, ref, states, steps)
    done = want[1].done.numpy()
    first = [int(np.argmax(done[:, b])) for b in range(3) if done[:, b].any()]
    assert first and any(f % SMALL_S for f in first), first
    assert_same_run(P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                     backend="cuda"), want)


def test_chunked_loop_chained_from_a_later_step(small_chunks):
    """A second call from the first one's final state (step0 > 0) gives
    the list loop's chained run, and the two calls together one run."""
    cfg, ref = _cfg(), _ref()
    states = _batch(cfg, 2)
    a = 2 * SMALL_S + 1
    s1, r1 = P.simulate_batch(ARM, cfg, SIM, ref, states, a, backend="cuda")
    assert int(s1.step.min()) > 0
    got = P.simulate_batch(ARM, cfg, SIM, ref, s1, SMALL_S + 2,
                           backend="cuda")
    assert_same_run(got, list_loop(ARM, cfg, SIM, ref, s1, SMALL_S + 2))
    whole = list_loop(ARM, cfg, SIM, ref, states, a + SMALL_S + 2)
    for f, x, y1, y2 in zip(whole[1]._fields, whole[1], r1, got[1]):
        assert torch.equal(x, torch.cat([y1, y2])), f


def test_chunked_loop_injected_noise(small_chunks):
    """eps mode runs the chunked loop eagerly: each chunk reads its own
    steps' noise."""
    cfg, ref = _cfg(), _ref()
    states = _batch(cfg, 2)
    steps = SMALL_S + 3
    eps = torch.as_tensor((np.random.default_rng(5).normal(
        size=(steps, 2, cfg.num_samples, cfg.horizon, 2)) * np.sqrt(20.0))
        .astype(np.float32))
    assert_same_run(P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                     eps_per_step=eps, backend="cuda"),
                    list_loop(ARM, cfg, SIM, ref, states, steps, eps))


def test_chunked_loop_at_the_package_chunk_length():
    """One ragged chunk past the package's own ``_GRAPH_STEPS``."""
    cfg, ref = _cfg(16, 4), _ref()
    states = _batch(cfg, 1)
    steps = ploop._GRAPH_STEPS + 3
    assert_same_run(P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                     backend="cuda"),
                    list_loop(ARM, cfg, SIM, ref, states, steps))


def test_float64_state_keeps_its_dtypes(small_chunks):
    """The record buffers take the state's dtypes, as the stacked rows
    did."""
    cfg, ref = _cfg(), _ref().double()
    states = P.init_sim_batch(cfg, SIM, [3, 4], dtype=torch.float64,
                              device="cpu")
    steps = SMALL_S + 1
    assert_same_run(P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                     backend="cuda"),
                    list_loop(ARM, cfg, SIM, ref, states, steps))


@pytest.fixture
def graphs_on_cpu(replaying_capture, counted_kernels, small_chunks,  # noqa
                  monkeypatch):
    """The loop's chunks as graphs on CPU tensors under the replaying
    stand-in, the cuda backend's kernels counted as on the card; returns
    the list of the captures made."""
    made = []
    capture = cuda_graphs.capture

    def counted(*a, **k):
        made.append(capture(*a, **k))
        return made[-1]

    monkeypatch.setattr(cuda_graphs, "capture", counted)
    return made


def test_a_new_keys_first_chunk_runs_uncaptured(graphs_on_cpu):
    """A run of one chunk under a new key runs it uncaptured and captures
    nothing; the next run's chunk captures and replays.  Both give the
    uncaptured loop's bits."""
    cfg, ref = _cfg(), _ref()
    states = _batch(cfg, 2)
    with cuda_graphs.uncaptured():
        want = ploop._step_loop(ARM, cfg, SIM, ref, states, SMALL_S)
    assert not ploop._GRAPHS
    first = ploop._step_loop(ARM, cfg, SIM, ref, states, SMALL_S)
    (entry,) = ploop._GRAPHS.values()
    assert entry.warm and entry.captured is None and not graphs_on_cpu
    assert_same_run(first, want)
    assert_same_run(ploop._step_loop(ARM, cfg, SIM, ref, states, SMALL_S),
                    want)
    assert entry.captured is not None and len(graphs_on_cpu) == 1


def _clustered(monkeypatch, layout_clustered: bool, tails_clustered: bool):
    """The key's tail layout that of a card of 132 SMs and 15 cluster
    slots (a cluster a scenario at K = 16384) or of the CPU (none), and
    the step tail counted in ``cuda_step.CLUSTER_TAILS`` or not."""
    layout = cuda_step._tail_layout_on
    monkeypatch.setattr(
        cuda_step, "_tail_layout_on", lambda K, B, device:
        cuda_step.step_tail_layout(K, B, 132, 15) if layout_clustered
        else layout(K, B, device))
    tail = cuda_step.step_tail

    def counted(*a, **k):
        cuda_step.CLUSTER_TAILS += int(tails_clustered)
        return tail(*a, **k)

    monkeypatch.setattr(cuda_step, "step_tail", counted)


def test_replays_count_the_cluster_tails_their_capture_recorded(
        graphs_on_cpu, monkeypatch):
    """A large-K chunk's capture records its tails that ran on a cluster,
    as its key's layout says they do (``cuda_step.CLUSTER_TAILS``, as the
    tail's wrapper counts them on the card), and leaves the count as it
    found it; each replay adds them, as it adds the tails."""
    _clustered(monkeypatch, True, True)
    cfg, ref = _cfg(16384, 6), _ref()
    states = _batch(cfg, 2)
    before = (cuda_step.TAIL_LAUNCHES, cuda_step.CLUSTER_TAILS)
    chunks = 3
    ploop._step_loop(ARM, cfg, SIM, ref, states, chunks * SMALL_S)
    (c,) = graphs_on_cpu
    at = [name for _, name in cuda_graphs.COUNTERS].index("CLUSTER_TAILS")
    assert c.recorded[at] == SMALL_S
    assert cuda_step.CLUSTER_TAILS - before[1] == \
        cuda_step.TAIL_LAUNCHES - before[0] == chunks * SMALL_S


@pytest.mark.parametrize("W", [30, 7, 33])
def test_replays_count_the_compiled_scans_their_capture_recorded(
        graphs_on_cpu, W):
    """A chunk's capture records a solve a step on the compiled-width
    window scan where ``cuda_sim.scan_width`` gives the key's plan one
    (W = 30 at one lane a sample, the CPU's layout) and none at another
    width (``cuda_solve.COMPILED_SCANS``, as the wrapper counts them on
    the card); each replay adds what the capture recorded."""
    cfg, ref = dataclasses.replace(_cfg(), search_idx_len=W), _ref()
    states = _batch(cfg, 2)
    before = (cuda_solve.LAUNCHES, cuda_solve.COMPILED_SCANS)
    chunks = 3
    ploop._step_loop(ARM, cfg, SIM, ref, states, chunks * SMALL_S)
    (c,) = graphs_on_cpu
    at = [name for _, name in cuda_graphs.COUNTERS].index("COMPILED_SCANS")
    compiled = W == cuda_sim.SCAN_WIDTH
    assert c.recorded[at] == SMALL_S * compiled
    assert cuda_solve.LAUNCHES - before[0] == chunks * SMALL_S
    assert cuda_solve.COMPILED_SCANS - before[1] == \
        chunks * SMALL_S * compiled


@pytest.mark.parametrize("layout_clustered", [True, False])
def test_a_chunk_capture_raises_when_cluster_tails_disagree_with_its_layout(
        graphs_on_cpu, monkeypatch, layout_clustered):
    """A chunk whose key's tail layout runs on a cluster must record a
    cluster tail a step, and one whose layout does not none: a capture
    that recorded otherwise raises and counts nothing."""
    _clustered(monkeypatch, layout_clustered, not layout_clustered)
    cfg, ref = _cfg(16384, 6), _ref()
    states = _batch(cfg, 2)
    ploop._step_loop(ARM, cfg, SIM, ref, states, SMALL_S)
    counts = cuda_graphs.launch_counts()
    expected = (f"not .*cuda_step.CLUSTER_TAILS {SMALL_S}" if layout_clustered
                else f"recorded .*cuda_step.CLUSTER_TAILS {SMALL_S}, not")
    with pytest.raises(RuntimeError, match=f"a captured chunk .*{expected}"):
        ploop._step_loop(ARM, cfg, SIM, ref, states, SMALL_S)
    assert cuda_graphs.launch_counts() == counts


def test_replays_count_the_statistics_launches_their_capture_recorded(
        graphs_on_cpu, monkeypatch):
    """A chunk whose statistics run on a branch (``_branched``, forced
    here) records a statistics launch a step beside its tails
    (``cuda_step.STATS_LAUNCHES``), each replay adds them, and its
    records are the fused tail's uncaptured loop's bit for bit."""
    cfg, ref = _cfg(64, 6), _ref()
    states = _batch(cfg, 2)
    with cuda_graphs.uncaptured():
        want = ploop._step_loop(ARM, cfg, SIM, ref, states, 3 * SMALL_S)
    monkeypatch.setattr(ploop, "_branched", lambda *a, **k: True)
    before = (cuda_step.TAIL_LAUNCHES, cuda_step.STATS_LAUNCHES)
    chunks = 3
    got = ploop._step_loop(ARM, cfg, SIM, ref, states, chunks * SMALL_S)
    (c,) = graphs_on_cpu
    at = [name for _, name in cuda_graphs.COUNTERS].index("STATS_LAUNCHES")
    assert c.recorded[at] == SMALL_S
    assert cuda_step.STATS_LAUNCHES - before[1] == \
        cuda_step.TAIL_LAUNCHES - before[0] == chunks * SMALL_S
    assert_same_run(got, want)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs replay CUDA kernels")
    return torch.device("cuda", 0)


def _eager(cfg, ref, states, steps):
    with cuda_graphs.uncaptured():
        return ploop._step_loop(ARM, cfg, SIM, ref, states, steps)


def _graph(cfg, ref, states, steps):
    return P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                            backend="cuda")


def _arc(dev):
    """A 40-waypoint arc whose end the loop reaches in about 50 steps."""
    return torch.as_tensor(P.synth_circle_path(40, revolutions=0.02),
                           dtype=torch.float32, device=dev)


def _path_end_start(cfg, ref, B, dev, steps):
    """Start waypoints on :func:`_arc` that put a scenario's path end
    inside a chunk of the package's length: the first of a few candidates
    whose eager run freezes a scenario at a step that does not begin a
    chunk."""
    S = ploop._GRAPH_STEPS
    for base in (0, 10, 20, 30):
        states = _batch(cfg, B, dev, [base + b % 8 for b in range(B)])
        done = _eager(cfg, ref, states, steps)[1].done.cpu().numpy()
        first = [int(np.argmax(done[:, b])) for b in range(B)
                 if done[:, b].any()]
        if any(f % S for f in first):
            return states
    raise AssertionError("no candidate froze inside a chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,B", [(1024, 50, 1), (128, 30, 64)])
def test_graph_loop_equals_eager_loop(dev, K, T, B):
    cfg = _cfg(K, T)
    ref = _arc(dev)
    steps = 5 * ploop._GRAPH_STEPS + 5      # the arc's end comes near 50
    states = _path_end_start(cfg, ref, B, dev, steps)
    want = _eager(cfg, ref, states, steps)
    assert_same_run(_graph(cfg, ref, states, steps), want)


@pytest.mark.cuda
def test_graph_cache_reuses_one_capture(dev):
    """A second call at the same shape replays the graphs of the first;
    a chained call from step0 > 0 too.  Every run equals the eager loop."""
    cfg, ref = _cfg(256, 20), _ref(2000, dev)
    states = _batch(cfg, 3, dev)
    steps = ploop._GRAPH_STEPS + 7
    got = _graph(cfg, ref, states, steps)
    graphs = dict(ploop._GRAPHS)
    again = _graph(cfg, ref, states, steps)
    assert all(ploop._GRAPHS[k] is g for k, g in graphs.items())
    assert len(ploop._GRAPHS) == len(graphs)
    want = _eager(cfg, ref, states, steps)
    assert_same_run(got, want)
    assert_same_run(again, want)
    chained = _graph(cfg, ref, got[0], steps)
    assert len(ploop._GRAPHS) == len(graphs)
    assert_same_run(chained, _eager(cfg, ref, want[0], steps))


@pytest.mark.cuda
def test_graph_loops_on_two_streams_at_once(dev):
    """Two runs on two streams at once give the bits they give in turn:
    each stream has its own graphs, buffers and arrival counters."""
    cfg, ref = _cfg(1024, 50), _ref(2000, dev)
    runs = [_batch(cfg, 1, dev), _batch(cfg, 4, dev)]
    steps = ploop._GRAPH_STEPS + 9
    want = [_graph(cfg, ref, s, steps) for s in runs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in runs]
    for _ in range(2):
        got = []
        for s, st in zip(streams, runs):
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                got.append(_graph(cfg, ref, st, steps))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert_same_run(g, w)


@pytest.mark.cuda
def test_graph_loop_counts_one_solve_launch_a_step(dev, monkeypatch):
    """The first call runs each chunk length's first chunk uncaptured, and
    captures and replays the rest; the second captures the chunk length
    the first ran once and replays the rest: each adds exactly its steps,
    as the launches each graph's capture recorded."""
    monkeypatch.setattr(ploop, "_GRAPHS", type(ploop._GRAPHS)())
    cfg, ref = _cfg(512, 16), _ref(2000, dev)
    states = _batch(cfg, 2, dev)
    steps = 2 * ploop._GRAPH_STEPS + 3
    for _ in range(2):
        before = cuda_solve.LAUNCHES
        _graph(cfg, ref, states, steps)
        torch.cuda.synchronize()
        assert cuda_solve.LAUNCHES == before + steps
    solves = [dict(zip(cuda_graphs.COUNTERS, e.captured.recorded))[
        cuda_solve, "LAUNCHES"] for e in ploop._GRAPHS.values()]
    assert sorted(solves) == [3, ploop._GRAPH_STEPS]


@pytest.mark.cuda
def test_graph_is_not_replayed_under_another_plan(dev, monkeypatch):
    """Forcing the solve's tile through ``cuda_solve._plan`` captures new
    graphs, whose records are the eager loop's under that tile (at lam =
    3e5, where tens of samples weigh, the tile's rounding shows in u)."""
    cfg = dataclasses.replace(_cfg(1024, 50), lam=3e5)
    ref = _ref(2000, dev)
    states = _batch(cfg, 1, dev)
    steps = ploop._GRAPH_STEPS + 2
    base = _graph(cfg, ref, states, steps)
    keys = set(ploop._GRAPHS)
    plan = cuda_solve._plan
    monkeypatch.setattr(cuda_solve, "_plan",
                        lambda c, K, t, *a, **k: plan(c, K, t or 128, *a,
                                                      **k))
    got = _graph(cfg, ref, states, steps)
    assert set(ploop._GRAPHS) - keys
    assert_same_run(got, _eager(cfg, ref, states, steps))
    assert not torch.equal(got[1].u, base[1].u)
