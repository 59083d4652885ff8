"""The eager backend's loop (``sim/loop.py``: ``_eager_step``,
``_eager_steps_into`` and the chunked loop of ``_step_loop(...,
backend="eager")``) on the CPU, at small sizes:

* the bits of ``simulate(backend="eager")`` are pinned: the SHA-256 of the
  records and final state of a float32 and a float64 run, taken from the
  scenario-by-scenario host loop this loop replaced (one step of
  ``solve`` at a time, each record row made as the step ran);
* the chunked loop at chunk lengths 1, 3 and 16 against the per-step loop
  (:func:`per_step_loop`, a copy of the replaced loop over ``sim_step``)
  bit for bit: a path end inside a chunk, a run chained from a later
  step, and float64 keeping its dtypes;
* the graph path under a capture that records each chunk's program and
  replays it (:func:`replaying_capture`): the uncaptured loop's bits, one
  graph a chunk length, keyed by the backend, and a raise when a port
  kernel's launch shows in an eager chunk;
* no host reads: a chunk runs with ``Tensor.__bool__``, ``__int__``,
  ``__float__``, ``__index__``, ``item`` and ``tolist`` and a tensor made
  from host data raising, as a capture on the card would;
* a batch of B = 3 against each scenario run alone, bit for bit, and in
  float64 against the JAX package's ``simulate_batch(backend='xla')`` over
  20 steps to 1e-9, given the ε that JAX's key chain draws;
* ``tools/eager_loop.py``'s comparisons under the replaying capture.

Marked ``cuda`` and skipped without a card: the graphs against the
uncaptured loop and a batch against its scenarios alone, bit for bit.
The ``cuda`` tests need no JAX, so on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_eager_loop.py -m cuda
"""

import contextlib
import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.models.arm import fk_full
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.ops.weights import (effective_sample_size,
                                                 ordered_sum, weight_entropy)
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.tools import eager_loop

try:        # the GPU machine has no JAX: there only the cuda tests run
    import jax
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    from mppi_robotarm_tpu.mppi.solver import sample_epsilon
    from mppi_robotarm_tpu.ops.noise import sigma_cholesky
    from _torch_port_helpers import configs, n
except ImportError:
    J = None

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()

# SHA-256 of records and final state (:func:`digest`) of the two pinned
# runs (:func:`pinned_run`), from the loop this one replaced
PINNED = {
    "float32": "cae4f182715386de707094d9f758219f71e707621a689700a5144de2fada5180",
    "float64": "6f86fe20d449a10e26da4248207935114507a9768749fcce304190482dfb1701",
}


def _cfg(K=32, T=6, **kw):
    return dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T, **kw)


def _ref(rows=2000, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(P.synth_circle_path(rows), dtype=dtype,
                           device=device)


def _arc(dtype=torch.float32, device="cpu"):
    """A 40-waypoint arc whose end the loop reaches near step 52 from
    index 0."""
    return torch.as_tensor(P.synth_circle_path(40, revolutions=0.02),
                           dtype=dtype, device=device)


def _batch(cfg, B, dtype=torch.float32, device="cpu", step0=None):
    q0 = (np.array([SIM.q0]) + 0.01 * np.random.default_rng(B).normal(
        size=(B, 2)))
    st = P.init_sim_batch(cfg, SIM, np.arange(B) * 7 + 1, q0=q0,
                          dtype=dtype, device=device)
    if step0 is not None:
        st = st._replace(step=torch.as_tensor(step0, device=device))
    return st


def digest(final, rec) -> str:
    h = hashlib.sha256()
    for v in (*rec, final.step, final.q, final.dq, *final.mppi, final.done,
              torch.as_tensor(final.seed)):
        a = np.ascontiguousarray(v.numpy())
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def pinned_run(dtype: str):
    """float32: K=64, T=8, exploration 0.1, 24 steps chained from step 3
    on the 2000-point circle; float64: K=32, T=6, 60 steps on the arc,
    whose end it reaches at step 52."""
    if dtype == "float32":
        cfg = _cfg(64, 8, exploration=0.1)
        s0 = P.init_sim(cfg, SIM, seed=5, device="cpu")._replace(
            step=torch.tensor(3))
        return P.simulate(ARM, cfg, SIM, _ref(), s0, 24)
    cfg = _cfg(32, 6)
    s0 = P.init_sim(cfg, SIM, seed=2, dtype=torch.float64, device="cpu")
    return P.simulate(ARM, cfg, SIM, _arc(torch.float64), s0, 60)


def per_step_loop(arm, cfg, sim, ref_path, state0, num_steps,
                  eps_per_step=None):
    """The loop this one replaced: ``sim_step`` a step, each step's record
    row made from its result, the rows stacked after the loop."""
    state, rows = state0, []
    step0 = int(state0.step)
    for i in range(num_steps):
        eps = None if eps_per_step is None else eps_per_step[i]
        state, res = ploop.sim_step(arm, cfg, sim, ref_path, state, eps=eps)
        x1, y1, x2, y2 = fk_full(state.q[0], state.q[1], arm)
        row = ref_path[min(step0 + i + 1, ref_path.shape[0] - 1)]
        zero = lambda v: torch.where(state.done, torch.zeros_like(v), v)
        rows.append((state.q, state.dq, zero(res.u0), torch.stack([x2, y2]),
                     torch.stack([x1, y1]), row[0:2], state.mppi.wp_idx,
                     zero(torch.amin(res.costs)), zero(torch.mean(res.costs)),
                     zero(effective_sample_size(res.weights)),
                     zero(weight_entropy(res.weights)), state.done))
    return state, P.SimRecord(*(torch.stack(f) for f in zip(*rows)))


def assert_same_run(got, want):
    """Two (final state, record) results equal bit for bit, dtypes too."""
    (fg, rg), (fw, rw) = got, want
    for f, a, b in zip(rg._fields, rg, rw):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for a, b in zip((fg.step, fg.q, fg.dq, *fg.mppi, fg.done),
                    (fw.step, fw.q, fw.dq, *fw.mppi, fw.done)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(torch.as_tensor(fg.seed), torch.as_tensor(fw.seed))


def _scenario(states, b):
    return ploop._scenario(states, b, int(states.seed[b]))


# ---- the pinned bits and the chunks ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pinned_bits_of_simulate_eager(dtype):
    final, rec = pinned_run(dtype)
    assert rec.q.dtype == getattr(torch, dtype)
    assert digest(final, rec) == PINNED[dtype]


@pytest.mark.parametrize("case", ["circle", "path_end", "chained",
                                  "float64"])
@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunked_loop_equals_per_step_loop(monkeypatch, chunk, case):
    monkeypatch.setattr(ploop, "_EAGER_GRAPH_STEPS", chunk)
    dtype = torch.float64 if case == "float64" else torch.float32
    cfg = _cfg(32, 6, exploration=0.2 if case == "circle" else 0.0)
    ref = _arc(dtype) if case == "path_end" else _ref(dtype=dtype)
    s0 = P.init_sim(cfg, SIM, seed=9, dtype=dtype, device="cpu")
    steps = 20
    if case in ("chained", "path_end"):   # from step 40, the arc's end 14
        s0, _ = P.simulate(ARM, cfg, SIM, ref, s0, 40)   # steps later
        assert int(s0.step) == 40
    want = per_step_loop(ARM, cfg, SIM, ref, s0, steps)
    got = P.simulate(ARM, cfg, SIM, ref, s0, steps)
    assert_same_run(got, want)
    if case == "path_end":
        done = want[1].done.numpy()
        first = int(np.argmax(done))
        assert done[-1] and first % 3 and first % 16, first
    if case == "float64":
        assert got[1].u.dtype == got[1].cost_mean.dtype == torch.float64


def test_chunked_loop_with_injected_noise(monkeypatch):
    """eps mode reads each step's noise from its chunk's slice."""
    monkeypatch.setattr(ploop, "_EAGER_GRAPH_STEPS", 3)
    cfg = _cfg(32, 6)
    steps = 8
    eps = torch.as_tensor(np.random.default_rng(4).normal(
        size=(steps, 32, 6, 2)) * np.sqrt(20.0), dtype=torch.float32)
    s0 = P.init_sim(cfg, SIM, seed=1, device="cpu")
    assert_same_run(P.simulate(ARM, cfg, SIM, _ref(), s0, steps,
                               eps_per_step=eps),
                    per_step_loop(ARM, cfg, SIM, _ref(), s0, steps, eps))


# ---- graphs, replayed on the CPU --------------------------------------------

class _Stream:
    cuda_stream = 7

    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class _Graph:
    """torch.cuda.CUDAGraph stand-in: replays the chunk program recorded
    while it was captured."""

    program = None

    def replay(self):
        self.program()


@pytest.fixture
def replaying_capture(monkeypatch):
    """torch.cuda's graph and stream calls answered on CPU tensors: a
    capture runs its chunk once, as the real one records it, and keeps
    the chunk's program (``sim/loop.py::_chunk`` on the graph's buffers),
    which each replay runs again."""
    capturing = []

    @contextlib.contextmanager
    def graph(g, stream=None):
        capturing.append(g)
        try:
            yield
        finally:
            capturing.pop()

    chunk = ploop._chunk

    def recorded(*a, **k):
        if capturing:
            capturing[-1].program = lambda: chunk(*a, **k)
        return chunk(*a, **k)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    monkeypatch.setattr(ploop, "_chunk", recorded)
    monkeypatch.setattr(ploop, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(ploop, "_GRAPHS", OrderedDict())


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_graphs_replay_the_uncaptured_bits(replaying_capture, monkeypatch,
                                           chunk):
    monkeypatch.setattr(ploop, "_EAGER_GRAPH_STEPS", chunk)
    cfg, ref = _cfg(32, 6), _ref()
    states = _batch(cfg, 2, step0=[0, 4])
    steps = 10
    want = ploop._step_loop(ARM, cfg, SIM, ref, states, steps, graphs=False,
                            backend="eager")
    counts = ploop._launch_counts()
    got = ploop._step_loop(ARM, cfg, SIM, ref, states, steps, graphs=True,
                           backend="eager")
    assert_same_run(got, want)
    again = ploop._step_loop(ARM, cfg, SIM, ref, got[0], steps, graphs=True,
                             backend="eager")
    assert_same_run(again, ploop._step_loop(ARM, cfg, SIM, ref, want[0],
                                            steps, graphs=False,
                                            backend="eager"))
    lengths = {min(chunk, steps), steps % chunk} - {0}
    assert sorted(g.n for g in ploop._GRAPHS.values()) == sorted(lengths)
    assert all(k[0] == "eager" for k in ploop._GRAPHS)
    assert all(g.launches == 0 and g.step_launches == (0, 0, 0)
               for g in ploop._GRAPHS.values())
    assert ploop._launch_counts() == counts


def test_graph_key_holds_the_backend():
    cfg, ref = _cfg(32, 6), _ref()
    states = _batch(cfg, 1)
    key = lambda backend: ploop._graph_key(ARM, cfg, SIM, ref, states, 4,
                                           _Stream, backend)
    assert key("eager") != key("cuda")
    assert key("eager")[0] == "eager" and key("eager")[7] is None
    assert key("cuda") == ploop._graph_key(ARM, cfg, SIM, ref, states, 4,
                                           _Stream)


@pytest.mark.parametrize("counter", [(cuda_solve, "LAUNCHES"),
                                     (cuda_step, "TAIL_LAUNCHES"),
                                     (cuda_sim, "FLEET_LAUNCHES")])
def test_an_eager_chunk_with_a_port_kernel_launch_raises(
        replaying_capture, monkeypatch, counter):
    """The eager backend never runs a port kernel: a capture that records
    one raises, naming it, and leaves every count as it found it."""
    mod, name = counter
    step = ploop._eager_step

    def launching(*a, **k):
        setattr(mod, name, getattr(mod, name) + 1)
        return step(*a, **k)

    monkeypatch.setattr(ploop, "_eager_step", launching)
    cfg, ref = _cfg(32, 6), _ref()
    counts = ploop._launch_counts()
    with pytest.raises(RuntimeError, match=f"launched the port's kernels: "
                       f".*{name} 3"):
        ploop._capture(ARM, cfg, SIM, ref, _batch(cfg, 2), 3, _Stream,
                       backend="eager")
    assert ploop._launch_counts() == counts


# ---- no host reads -----------------------------------------------------------

def test_the_eager_chunk_reads_nothing_from_the_host(monkeypatch):
    """A chunk after its first step (which makes the cached constants, as
    the capture's warm-up does) runs with every host read of a tensor and
    every tensor made from host data raising."""
    cfg, ref = _cfg(32, 6, exploration=0.25), _ref()
    states = _batch(cfg, 2, step0=[1, 6])
    clock = states.step.clone()
    want_rows = ploop._row_buffers(4, states, ref)
    want = ploop._eager_steps_into(ARM, cfg, SIM, ref, states, clock, None,
                                   want_rows)
    rows = ploop._row_buffers(4, states, ref)

    def host_read(self, *a, **k):
        raise AssertionError("the eager step read a tensor on the host")

    for attr in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist"):
        monkeypatch.setattr(torch.Tensor, attr, host_read)
    for name in ("tensor", "as_tensor"):
        made = getattr(torch, name)

        def from_tensors_only(data, *a, _made=made, **k):
            if not isinstance(data, torch.Tensor):
                raise AssertionError("the eager step copied host data")
            return _made(data, *a, **k)

        monkeypatch.setattr(torch, name, from_tensors_only)
    final, end = ploop._eager_steps_into(ARM, cfg, SIM, ref, states, clock,
                                         None, rows)
    monkeypatch.undo()
    assert torch.equal(end, want[1]) and torch.equal(end, clock + 4)
    for a, b in zip(rows, want_rows):
        assert torch.equal(a, b)
    for a, b in zip(ploop._state_tensors(final),
                    ploop._state_tensors(want[0])):
        assert torch.equal(a, b)


# ---- batches -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_equals_each_scenario_alone(dtype):
    cfg = _cfg(100, 8, exploration=0.1)
    ref = _ref(dtype=dtype)
    states = _batch(cfg, 3, dtype, step0=[0, 5, 2])
    final, rec = P.simulate_batch(ARM, cfg, SIM, ref, states, 12)
    assert rec.q.shape == (12, 3, 2) and rec.cost_min.dtype == dtype
    for b in range(3):
        f1, r1 = P.simulate(ARM, cfg, SIM, ref, _scenario(states, b), 12)
        for field, a, c in zip(rec._fields, rec, r1):
            assert torch.equal(a[:, b], c), (b, field)
        for a, c in zip((final.q, final.dq, *final.mppi, final.step,
                         final.done),
                        (f1.q, f1.dq, *f1.mppi, f1.step, f1.done)):
            assert torch.equal(a[b], c)
    assert torch.equal(final.seed, states.seed)


def test_batch_matches_jax_simulate_batch_xla(ref_path):
    """JAX's batch draws each scenario's noise from its own key chain
    (``sim_step`` splits the key under the vmap); the port's batch is given
    that very ε.  Every record field to 1e-9 over the first 10 steps, and
    q, the EE and elbow, the reference rows, the index and the flags over
    all 20: the two loops agree to rounding at first, and from there the
    controls and costs part at the loop's Lyapunov rate (beyond 1e-9 at
    steps 11-19 over five key chains, 1e-5 in u by step 19 on this one),
    as in ``tests/test_torch_bench.py::test_the_slice_matches_jax_xla``."""
    if J is None:
        pytest.skip("needs the JAX package")
    steps, K, T, B = 20, 32, 10, 3
    cj, cp = configs(K, T)
    path = np.asarray(ref_path)
    q0 = np.asarray(SIM.q0) + 0.02 * np.arange(B)[:, None]
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    js = J.init_sim_batch(cj, J.SimConfig(), keys, q0=q0, dtype=jnp.float64)
    _, jrec = J.simulate_batch(J.ArmParams(), cj, J.SimConfig(),
                               jnp.asarray(path), js, steps, backend="xla")
    eps = np.empty((steps, B, K, T, 2))
    chol = sigma_cholesky(cj.sigma)
    for b in range(B):
        key = keys[b]
        for i in range(steps):
            key, sub = jax.random.split(key)
            eps[i, b] = np.asarray(sample_epsilon(sub, K, T, chol,
                                                  jnp.float64))
    ps = P.init_sim_batch(cp, SIM, np.arange(B), q0=q0, dtype=torch.float64,
                          device="cpu")
    _, prec = P.simulate_batch(ARM, cp, SIM, torch.as_tensor(path), ps,
                               steps, eps_per_step=torch.as_tensor(eps))
    for f in P.SimRecord._fields:
        whole = f in ("q", "ee", "elbow", "ref_xy", "wp_idx", "done")
        cut = steps if whole else 10
        np.testing.assert_allclose(n(getattr(prec, f))[:cut],
                                   np.asarray(getattr(jrec, f))[:cut],
                                   rtol=1e-9, atol=1e-9, err_msg=f)


# ---- ordered sums ------------------------------------------------------------

def test_ordered_sum_tree_is_the_cards_order(monkeypatch):
    """On the card ``ordered_sum`` adds pairwise, halving a zero-padded
    axis: each row's bits are those of its sum alone, whatever the batch,
    and within rounding of torch.sum.  Forced here on CPU tensors."""
    from mppi_robotarm_tpu_torch.ops import weights

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    rng = np.random.default_rng(3)
    for K in (1, 7, 100, 128):
        x = torch.as_tensor(rng.normal(size=(5, K, 3)), dtype=torch.float32)
        got = weights.ordered_sum(x, dim=1)
        for b in range(5):
            assert torch.equal(got[b], weights.ordered_sum(x[b:b + 1],
                                                           dim=1)[0])
        v = x[0, :, 0]
        tree = torch.cat([v, v.new_zeros((1 << (K - 1).bit_length()) - K)])
        while tree.numel() > 1:
            tree = tree[:tree.numel() // 2] + tree[tree.numel() // 2:]
        assert torch.equal(got[0, 0], tree[0])
        np.testing.assert_allclose(got.numpy(), x.sum(dim=1).numpy(),
                                   rtol=1e-5, atol=1e-5)
    monkeypatch.undo()
    x = torch.rand(4, 9)
    assert torch.equal(ordered_sum(x), torch.sum(x, dim=-1))


# ---- the tool, on the CPU ----------------------------------------------------

def test_eager_loop_tool_compares_on_the_cpu(replaying_capture, monkeypatch):
    """``tools/eager_loop.py``'s three comparisons at small sizes: every
    field 0.0 (bitwise); a perturbed run shows its difference."""
    cfg = _cfg(16, 5)

    def inputs(device, dtype=torch.float32, samples=None, horizon=None):
        st = P.init_sim(cfg, SIM, seed=0, dtype=dtype, device="cpu")
        return ARM, cfg, SIM, _ref(dtype=dtype), ploop._as_batch(st)

    monkeypatch.setattr(eager_loop, "bench_inputs", inputs)
    monkeypatch.setattr(eager_loop, "fleet_inputs",
                        lambda device: (ARM, cfg, SIM, _ref(),
                                        _batch(cfg, 4)))
    for name, v in (("BITS_STEPS", 6), ("SMALL_STEPS", 5), ("BATCH", 3)):
        monkeypatch.setattr(eager_loop, name, v)
    out = eager_loop.check_bits("cpu")
    assert len(out) == 3
    for label, diffs in out:
        assert set(diffs.values()) == {0.0}, label
    a = eager_loop.run(inputs("cpu"), 4, graphs=False)
    b = (a[0]._replace(q=a[0].q + 0.5), a[1])
    d = eager_loop.differences(b, a)
    assert d["final_q"] == pytest.approx(0.5) and d["q"] == 0.0


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs replay on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,B,dtype", [(1024, 50, 1, torch.float32),
                                         (128, 30, 4, torch.float64)])
def test_graphs_equal_the_uncaptured_loop_on_the_card(dev, monkeypatch, K, T,
                                                      B, dtype):
    monkeypatch.setattr(ploop, "_GRAPHS", OrderedDict())
    cfg = _cfg(K, T)
    ref = _arc(dtype, dev)
    states = _batch(cfg, B, dtype, dev)
    steps = 3 * ploop._EAGER_GRAPH_STEPS + 2
    want = ploop._step_loop(ARM, cfg, SIM, ref, states, steps, graphs=False,
                            backend="eager")
    got = P.simulate_batch(ARM, cfg, SIM, ref, states, steps)
    assert all(k[0] == "eager" for k in ploop._GRAPHS)
    for f, a, c in zip(got[1]._fields, got[1], want[1]):
        assert torch.equal(a, c), f
    for a, c in zip(ploop._state_tensors(got[0]),
                    ploop._state_tensors(want[0])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(c))


@pytest.mark.cuda
def test_batch_equals_each_scenario_alone_on_the_card(dev):
    cfg = _cfg(128, 30)
    ref = _ref(device=dev)
    states = _batch(cfg, 8, device=dev)
    final, rec = P.simulate_batch(ARM, cfg, SIM, ref, states, 20)
    for b in range(8):
        f1, r1 = P.simulate(ARM, cfg, SIM, ref, _scenario(states, b), 20)
        for field, a, c in zip(rec._fields, rec, r1):
            assert torch.equal(a[:, b], c), (b, field)
