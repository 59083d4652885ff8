"""The port's captured programs (``utils/cuda_graphs.py::run``), on the CPU
under the replaying stand-in (``_torch_port_helpers.py::
replaying_capture``) with the CPU let through as a graph device: the
per-call entry points (``mppi/solver.py::_call``: ``solve`` on both
backends, ``solve_batched`` and ``viz_rollouts``) and, in the cases the
two users share, the per-step loop's chunks (``sim/loop.py``):

* a replay equals the uncaptured call bit for bit, every field of the
  result, in float32 and float64, over a chain of 10 calls each fed the
  last one's result: ``solve`` eager (injected and generator-drawn noise)
  and cuda (injected and seeded, the plain versions on the CPU),
  ``solve_batched`` (seeded and injected) and ``viz_rollouts``;
* a key's first call runs uncaptured and its second captures;
  ``debug_mode`` and ``cuda_graphs.uncaptured()`` never capture;
* an earlier result is not overwritten by a later call, a generator
  leaves a graph call in the state the uncaptured call leaves it, a path
  changed in place between calls is seen (also when the write bumps no
  ``_version``), a new path tensor is seen, seed and step as Python ints
  (staged through the pinned buffer) and as tensors give the uncaptured
  bits, and a config that is invalid on a later call still raises;
* ``solver.REPLAYS`` and ``solver.MISSES`` over a chain of calls;
* for both users, per-call and chunk: the keys separate the launch plan,
  the backend, the shapes and dtypes (and a call's options and noise
  source, a chunk's steps); the launches and partials a capture records
  and each replay adds; the raise when a cuda capture records other
  launches than its user expects, and when an eager one launches a port
  kernel;
* a captured call with every host read of a tensor and every tensor made
  from host data raising;
* 20 calls of the compat drop-in through the graphs in float64 against
  the JAX package's ``MPPIControllerForPathTracking(backend="xla")`` on
  the same NumPy noise, to 1e-7 relative and 1e-9 absolute (the
  tolerance ``tests/test_torch_compat.py`` holds the oracle to).

Marked ``cuda`` and skipped without a card: the graphs against the
uncaptured calls, bit for bit, on the card, among them 200 back-to-back
seeded solves with no read between (the pinned buffer's guard) and a path
rewritten between replays by a write that bumps no ``_version``.  They
need no JAX:

    python -m pytest --noconftest tests/test_torch_call_graphs.py -m cuda
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.mppi import solver as psolver
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.utils import cuda_graphs, debug, spans
from _torch_port_helpers import _leaves
from _torch_port_helpers import (counted_kernels,  # noqa: F401 (fixtures)
                                 replaying_capture)

try:        # the GPU machine has no JAX: there only the cuda tests run
    import mppi_robotarm_tpu.compat as jcompat
except ImportError:
    jcompat = None

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()
CALLS = 10
CHUNK = 4            # the cuda backend's chunk length in the loop's cases


def _cfg(K=16, T=5, **kw):
    return dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T,
                               **kw)


def _ref(dtype=torch.float32, device="cpu"):
    return torch.as_tensor(P.synth_circle_path(2000), dtype=dtype,
                           device=device)


def _eps(seed, shape, dtype=torch.float32, device="cpu"):
    e = np.random.default_rng(seed).normal(size=(*shape, 2)) * np.sqrt(20.0)
    return torch.as_tensor(e, dtype=dtype, device=device)


def _x0(dtype=torch.float32, device="cpu", B=None):
    x = torch.tensor([1.1522, -1.2661, 0.0, 0.0], dtype=dtype, device=device)
    if B is None:
        return x
    return x + 0.01 * torch.arange(B, dtype=dtype, device=device)[:, None]


def _next_x(x, u0):
    """The next observation, fed from the result (a step of the plant's
    Euler on a made-up acceleration)."""
    return torch.cat([x[..., :2] + 0.003 * x[..., 2:],
                      x[..., 2:] + 0.003 * u0.to(x.dtype)], dim=-1)


def _fresh(v):
    """A result with every tensor cloned (NamedTuples kept, None kept)."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return type(v)(*map(_fresh, v)) if hasattr(v, "_fields") else tuple(
            map(_fresh, v))
    return v


def assert_same(a, b, where=""):
    """Two results equal bit for bit, field by field, dtypes included."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            assert_same(x, y, f"{where}.{k}")
    else:
        assert a == b, where


@pytest.fixture
def graphs_on_cpu(replaying_capture, counted_kernels,  # noqa: F811
                  monkeypatch):
    """The captured programs on CPU tensors, under the replaying stand-in,
    the cuda backend's kernels counted as on the card, the loop's cuda
    chunks :data:`CHUNK` steps; returns the list of the captures made."""
    monkeypatch.setattr(ploop, "_GRAPH_STEPS", CHUNK)
    made = []
    capture = cuda_graphs.capture

    def counted(*a, **k):
        made.append(capture(*a, **k))
        return made[-1]

    monkeypatch.setattr(cuda_graphs, "capture", counted)
    return made


# ---- the chains ------------------------------------------------------------

def solve_chain(backend, noise, dtype, calls=CALLS, device="cpu", cfg=None,
                generator=None, ref=None):
    """``calls`` solves, each fed the last one's state and observation."""
    cfg = cfg or _cfg(exploration=0.25)
    ref = _ref(dtype, device) if ref is None else ref
    x = _x0(dtype, device)
    state = P.init_state(cfg, dtype=dtype, device=device)
    out = []
    for i in range(calls):
        kw = {"eager": {"eps": dict(eps=_eps(i, (16, 5), dtype, device)),
                        "generator": dict(generator=generator)},
              "cuda": {"eps": dict(eps=_eps(i, (16, 5), dtype, device)),
                       "seed": dict(seed=5, step=i, want_eps=True)}}
        res = psolver.solve(ARM, cfg, ref, x, state, backend=backend,
                            **kw[backend][noise])
        out.append(res)
        state, x = res.state, _next_x(x, res.u0)
    return out


def batched_chain(noise, dtype, calls=CALLS, device="cpu", B=3, ref=None):
    """``calls`` calls of ``solve_batched`` of B scenarios, each fed the
    last one's state and observations."""
    cfg = _cfg()
    ref = _ref(dtype, device) if ref is None else ref
    x = _x0(dtype, device, B)
    state = psolver.MPPIState(
        u_prev=P.init_state(cfg, dtype=dtype, device=device).u_prev.repeat(
            B, 1, 1),
        wp_idx=torch.tensor([0, 3, 7], device=device))
    seeds = torch.tensor([1, 2, 3], device=device)
    out = []
    for i in range(calls):
        kw = (dict(seeds=seeds, step=torch.tensor([i, i + 4, 2 * i],
                                                  device=device))
              if noise == "seed" else
              dict(eps=_eps(i, (B, 16, 5), dtype, device)))
        res = psolver.solve_batched(ARM, cfg, ref, x, state, **kw)
        out.append(res)
        state, x = res.state, _next_x(x, res.u0)
    return out


def viz_chain(solved, dtype, device="cpu"):
    """``viz_rollouts`` of each solve of a chain on its pre-update
    sequence."""
    cfg = _cfg(exploration=0.25)
    x = _x0(dtype, device)
    u_prev = P.init_state(cfg, dtype=dtype, device=device).u_prev
    out = []
    for res in solved:
        out.append(psolver.viz_rollouts(ARM, cfg, x, res.u_seq, u_prev,
                                        res.eps, res.costs))
        u_prev, x = res.state.u_prev, _next_x(x, res.u0)
    return out


CHAINS = {
    "solve eager eps": lambda d, **k: solve_chain("eager", "eps", d, **k),
    "solve cuda eps": lambda d, **k: solve_chain("cuda", "eps", d, **k),
    "solve cuda seed": lambda d, **k: solve_chain("cuda", "seed", d, **k),
    "solve_batched seed": lambda d, **k: batched_chain("seed", d, **k),
    "solve_batched eps": lambda d, **k: batched_chain("eps", d, **k),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_a_replay_equals_the_uncaptured_call(graphs_on_cpu, chain, dtype):
    with cuda_graphs.uncaptured():
        want = CHAINS[chain](dtype)
    assert not graphs_on_cpu and not psolver._CALL_GRAPHS
    got = CHAINS[chain](dtype)
    assert_same(got, want, chain)
    assert len(graphs_on_cpu) == 1 and len(psolver._CALL_GRAPHS) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("source", ["eager", "cuda"])
def test_a_viz_replay_equals_the_uncaptured_call(graphs_on_cpu, source,
                                                 dtype):
    with cuda_graphs.uncaptured():
        solved = solve_chain(source, "eps" if source == "eager" else "seed",
                             dtype)
        want = viz_chain(solved, dtype)
    got = viz_chain(solved, dtype)
    assert_same(got, want)
    assert [k[0] for k in psolver._CALL_GRAPHS] == ["viz_rollouts"]
    assert len(graphs_on_cpu) == 1


def test_a_generator_leaves_the_same_state(graphs_on_cpu):
    """The eager backend draws its noise from the generator before the
    replay, as the uncaptured call draws it."""
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    with cuda_graphs.uncaptured():
        want = solve_chain("eager", "generator", torch.float64,
                           generator=gens[0])
    got = solve_chain("eager", "generator", torch.float64,
                      generator=gens[1])
    assert_same(got, want)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert len(graphs_on_cpu) == 1


# ---- when a call captures ------------------------------------------------------

def test_the_second_call_of_a_key_captures(graphs_on_cpu):
    cfg, ref, x = _cfg(), _ref(), _x0()
    state = P.init_state(cfg, device="cpu")
    call = lambda i: psolver.solve(ARM, cfg, ref, x, state,
                                   eps=_eps(i, (16, 5)))
    call(0)
    (g,) = psolver._CALL_GRAPHS.values()
    assert g.warm and g.captured is None and not graphs_on_cpu
    call(1)
    assert g.captured is not None and len(graphs_on_cpu) == 1
    for i in range(2, 5):
        call(i)
    assert len(graphs_on_cpu) == 1 and len(psolver._CALL_GRAPHS) == 1


def test_debug_mode_and_the_switch_never_capture(graphs_on_cpu):
    with debug.debug_mode():
        solve_chain("eager", "eps", torch.float32, calls=3)
    with cuda_graphs.uncaptured():
        solve_chain("cuda", "seed", torch.float32, calls=3)
    assert not graphs_on_cpu and not psolver._CALL_GRAPHS


def test_an_earlier_result_is_not_overwritten(graphs_on_cpu):
    cfg, ref, x = _cfg(), _ref(), _x0()
    state = P.init_state(cfg, device="cpu")
    call = lambda i: psolver.solve(ARM, cfg, ref, x, state,
                                   eps=_eps(i, (16, 5)))
    call(0)
    kept = call(1)                     # the capture's replay
    snapshot = _fresh(kept)
    later = call(2)                    # a replay of the same graph
    assert_same(kept, snapshot)
    assert not torch.equal(later.costs, kept.costs)
    out = graphs_on_cpu[0].out.result      # the graph's own buffers
    assert kept.costs.data_ptr() != out.costs.data_ptr()
    assert later.u_seq.data_ptr() != out.u_seq.data_ptr()


def test_a_path_changed_in_place_is_seen(graphs_on_cpu):
    cfg, x = _cfg(), _x0()
    ref = _ref()
    state = P.init_state(cfg, device="cpu")
    eps = _eps(0, (16, 5))
    call = lambda r: psolver.solve(ARM, cfg, r, x, state, eps=eps)
    call(ref)
    before = call(ref)
    ref[:, 0:2] += 0.05
    got = call(ref)
    with cuda_graphs.uncaptured():
        want = call(ref)
    assert_same(got, want)
    assert not torch.equal(got.costs, before.costs)
    assert len(graphs_on_cpu) == 1


@pytest.mark.parametrize("change", ["new tensor", "write bumping no version"])
def test_a_path_rewritten_or_replaced_is_seen(graphs_on_cpu, change):
    """The graph reads the caller's path where it lies: a write through
    NumPy (no ``_version`` bump) is seen by the next replay, and a new
    tensor of the same shape is a new key."""
    cfg, x = _cfg(), _x0()
    ref = _ref()
    state = P.init_state(cfg, device="cpu")
    eps = _eps(0, (16, 5))
    call = lambda r: psolver.solve(ARM, cfg, r, x, state, eps=eps)
    call(ref)
    before = call(ref)
    version = ref._version
    if change == "new tensor":
        ref = ref.clone()
        ref[:, 0:2] += 0.05
    else:
        ref.numpy()[:, 0:2] += 0.05
        assert ref._version == version
    got = [call(ref) for _ in range(3)]
    with cuda_graphs.uncaptured():
        want = call(ref)
    for res in got:
        assert_same(res, want)
    assert not torch.equal(got[0].costs, before.costs)
    assert len(graphs_on_cpu) == (2 if change == "new tensor" else 1)


@pytest.mark.parametrize("scalars", ["int", "tensor", "mixed"])
def test_seed_and_step_as_ints_or_tensors_give_the_uncaptured_bits(
        graphs_on_cpu, scalars):
    """Python ints go through the entry's pinned buffer, tensors are
    copied with the other inputs; both replay the uncaptured call's
    bits."""
    cfg = _cfg(exploration=0.25)
    ref, x0 = _ref(), _x0()

    def chain():
        state, x, out = P.init_state(cfg, device="cpu"), x0, []
        for i in range(CALLS):
            seed, step = 1000 + 7 * i, 3 * i
            if scalars in ("tensor", "mixed"):
                step = torch.tensor(step)
            if scalars == "tensor":
                seed = torch.tensor(seed)
            res = psolver.solve(ARM, cfg, ref, x, state, backend="cuda",
                                seed=seed, step=step, want_eps=True)
            out.append(res)
            state, x = res.state, _next_x(x, res.u0)
        return out

    with cuda_graphs.uncaptured():
        want = chain()
    spans.reset()
    with spans.recording():
        got = chain()
    assert_same(got, want, scalars)
    (g,) = psolver._CALL_GRAPHS.values()
    assert len(graphs_on_cpu) == 1
    copies = [s for s in spans.between(0, 1 << 62).spans
              if s.name == "graph.copy_in"]
    assert [s.n for s in copies] == [4 * 4 + 5 * 2 * 4 + 8 + 2 * 8] * (
        CALLS - 1)
    assert len(g.slots) == {"int": 2, "tensor": 0, "mixed": 1}[scalars]
    spans.reset()


@pytest.mark.parametrize("entry", ["solve", "solve_batched",
                                   "solve after viz_rollouts"])
def test_a_config_invalid_on_a_later_call_still_raises(graphs_on_cpu,
                                                       entry):
    """A config's check is kept only when it passed: one that fails
    raises at every call, before and after a valid config's replays, and
    after ``viz_rollouts`` (which checks nothing) has keyed it."""
    ref, x = _ref(), _x0()
    bad = dataclasses.replace(_cfg(), filter_window=0)
    if entry == "solve after viz_rollouts":
        u = P.init_state(_cfg(), device="cpu").u_prev
        eps = _eps(0, (16, 5))
        for _ in range(3):
            psolver.viz_rollouts(ARM, bad, x, u, u, eps, eps[:, 0, 0])

    def call(cfg):
        if entry != "solve_batched":
            state = P.init_state(_cfg(), device="cpu")
            return psolver.solve(ARM, cfg, ref, x, state, backend="cuda",
                                 seed=2, step=1)
        state = psolver.MPPIState(
            P.init_state(_cfg(), device="cpu").u_prev[None],
            torch.zeros(1, dtype=torch.int64))
        return psolver.solve_batched(ARM, cfg, ref, x[None], state,
                                     seeds=torch.tensor([2]),
                                     step=torch.tensor([1]))

    for _ in range(3):
        call(_cfg())
    for _ in range(2):
        with pytest.raises(ValueError, match="filter_window"):
            call(bad)
    call(_cfg())
    assert len(graphs_on_cpu) == (2 if entry.endswith("viz_rollouts") else 1)


PACKED = {
    "flat": lambda: (torch.arange(6.0), torch.tensor(3)),
    "nested and mixed": lambda: psolver.SolveResult(
        torch.arange(2.0), torch.ones(5, 2), psolver.MPPIState(
            torch.zeros(5, 2, dtype=torch.float64), torch.tensor(4)),
        torch.tensor(True), torch.arange(16.0), torch.arange(16.0) / 7,
        None),
    "offset and strided": lambda: (torch.arange(10)[3:5],
                                   torch.arange(12.0).reshape(3, 4).t(),
                                   torch.arange(8)[5]),
    "empty": lambda: (torch.zeros(0, 2), torch.arange(3.0), 7),
    "one tensor at an offset": lambda: (torch.arange(6.0),
                                        torch.arange(8)[5]),
}


@pytest.mark.parametrize("case", sorted(PACKED))
def test_a_packed_result_hands_back_fresh_equal_views(case):
    """``cuda_graphs.Packed``: the capture's result over the flat buffers,
    and each fresh result, equal the program's result field by field, in
    its shapes and dtypes, one buffer a dtype; a fresh result shares no
    memory with the buffers or with another fresh result."""
    out = PACKED[case]()
    packed = cuda_graphs.Packed(out)
    assert_same(packed.result, out)
    assert len(packed.flats) == len({t.dtype for t in _leaves(out)
                                     if t.numel()})
    a, b = packed.fresh(), packed.fresh()
    assert_same(a, out)
    assert_same(b, out)
    mine = {f.untyped_storage().data_ptr() for f in packed.flats}
    for x, y in zip(_leaves(a), _leaves(b)):
        if x.numel():
            assert x.untyped_storage().data_ptr() not in mine
            assert x.untyped_storage().data_ptr() != \
                y.untyped_storage().data_ptr()



def test_the_counts_of_replays_and_misses(graphs_on_cpu):
    """A chain of 10 calls on one path: its first call and its capture
    miss, 8 replay; a new path tensor misses twice more."""
    replays, misses = psolver.REPLAYS, psolver.MISSES
    solve_chain("cuda", "seed", torch.float32)
    assert (psolver.REPLAYS - replays, psolver.MISSES - misses) == (8, 2)
    cfg, ref, x = _cfg(), _ref().clone(), _x0()
    state = P.init_state(cfg, device="cpu")
    for i in range(3):
        psolver.solve(ARM, cfg, ref, x, state, backend="cuda", seed=4,
                      step=i)
    assert (psolver.REPLAYS - replays, psolver.MISSES - misses) == (9, 4)
    with cuda_graphs.uncaptured():
        solve_chain("cuda", "seed", torch.float32, calls=3)
    assert (psolver.REPLAYS - replays, psolver.MISSES - misses) == (9, 4)


# ---- both users: keys and launch counts -----------------------------------

def loop_chain(calls, backend="cuda", dtype=torch.float32, ref=None,
               steps=None):
    """``calls`` chunks of the per-step loop on ``backend``: one run of
    ``calls`` chunks (or of ``steps`` steps) from a batch of two."""
    cfg = _cfg()
    st = P.init_sim_batch(cfg, SIM, [3, 4], dtype=dtype, device="cpu")
    n = steps or calls * ploop._chunk_steps(backend)
    return ploop._step_loop(ARM, cfg, SIM, _ref(dtype) if ref is None
                            else ref, st, n, backend=backend)


PATH = _ref()        # one path for the per-call uses: its address is keyed
USES = {     # a user's ``calls`` uses of the cuda backend's program
    "solve": lambda calls: solve_chain("cuda", "seed", torch.float32,
                                       calls=calls, ref=PATH),
    "solve_batched": lambda calls: batched_chain("seed", torch.float32,
                                                 calls=calls, ref=PATH),
    "chunk": loop_chain,
}
PER_USE = {  # the launches a use records, and its scenarios (one lane a
    # sample without a card, so at the default window every solve takes
    # the compiled-width scan)
    "solve": ({(cuda_solve, "LAUNCHES"): 1,
               (cuda_solve, "COMPILED_SCANS"): 1,
               (cuda_step, "HEAD_LAUNCHES"): 1}, 1),
    "solve_batched": ({(cuda_solve, "LAUNCHES"): 1,
                       (cuda_solve, "COMPILED_SCANS"): 1,
                       (cuda_step, "HEAD_LAUNCHES"): 1}, 3),
    "chunk": ({(cuda_solve, "LAUNCHES"): CHUNK,
               (cuda_solve, "COMPILED_SCANS"): CHUNK,
               (cuda_step, "HEAD_LAUNCHES"): 1,
               (cuda_step, "TAIL_LAUNCHES"): CHUNK,
               (cuda_step, "CARRIED_HEADS"): CHUNK - 1}, 2),
}


def _forced_tile(monkeypatch, calls):
    """``calls()`` with the solve's tile forced to 32 through
    ``cuda_solve._plan``, as ``fused_timing.py --tile`` forces one."""
    plan = cuda_solve._plan
    monkeypatch.setattr(cuda_solve, "_plan", lambda c, K, t, *a, **k:
                        plan(c, K, t or 32, *a, **k))
    calls()
    monkeypatch.setattr(cuda_solve, "_plan", plan)


def _solve_keys(monkeypatch):
    """Variants of ``solve``, each called twice (its second call
    captures)."""
    ref, x = _ref(), _x0()

    def calls(**kw):
        cfg = kw.pop("cfg", _cfg())
        dtype = kw.pop("dtype", torch.float32)
        state = P.init_state(cfg, dtype=dtype, device="cpu")
        # one path tensor for both calls: its address is in the key
        path = ref.to(dtype)
        for _ in range(2):
            psolver.solve(ARM, cfg, path, x.to(dtype), state, **kw)

    return {
        "eager": lambda: calls(eps=_eps(0, (16, 5))),
        "float64": lambda: calls(eps=_eps(0, (16, 5), torch.float64),
                                 dtype=torch.float64),
        "K=32": lambda: calls(eps=_eps(0, (32, 5)), cfg=_cfg(32)),
        "generator": lambda: calls(
            generator=torch.Generator().manual_seed(0)),
        "cuda": lambda: calls(eps=_eps(0, (16, 5)), backend="cuda"),
        "seeded": lambda: calls(seed=3, backend="cuda"),
        "want_eps": lambda: calls(seed=3, backend="cuda", want_eps=True),
        # a config object of its own, whose plan is computed anew
        "tile 32": lambda: _forced_tile(monkeypatch, lambda: calls(
            eps=_eps(0, (16, 5)), backend="cuda", cfg=_cfg())),
    }


def _chunk_keys(monkeypatch):
    """Variants of the per-step loop, each run twice (its second run's
    first chunk captures)."""
    def twice(**kw):
        for _ in range(2):
            loop_chain(1, **kw)

    return {
        "cuda": twice,
        "eager": lambda: twice(backend="eager"),
        "float64": lambda: twice(dtype=torch.float64),
        "3 steps": lambda: twice(steps=CHUNK - 1),
        "100 path rows": lambda: twice(ref=_ref()[:100]),
        "tile 32": lambda: _forced_tile(monkeypatch, twice),
    }


@pytest.mark.parametrize("user", ["solve", "chunk"])
def test_keys_separate_backend_dtype_shape_options_and_noise(
        graphs_on_cpu, monkeypatch, user):
    """Each variant of a user's calls is a key of its own and a capture
    of its own: the launch plan (a tile forced through
    ``cuda_solve._plan``), the backend, the dtype and the shapes, and a
    call's options and noise source or a chunk's steps and path rows."""
    cache = psolver._CALL_GRAPHS if user == "solve" else ploop._GRAPHS
    keys = {}
    for name, calls in (_solve_keys if user == "solve" else _chunk_keys)(
            monkeypatch).items():
        before = set(cache)
        calls()
        (keys[name],) = set(cache) - before
        assert cache[keys[name]].captured is not None, name
    assert len(set(keys.values())) == len(keys) == len(graphs_on_cpu)
    plan = psolver.step_solve_plan(_cfg(), 1 if user == "solve" else 2,
                                   torch.device("cpu"))
    if user == "solve":
        eager, cuda = keys["eager"], keys["cuda"]
        assert eager[3] == "eager" and cuda[3] == "cuda"
        assert eager[4:6] == (ARM, _cfg())
        assert cuda[-2] == plan != keys["tile 32"][-2]
    else:
        assert [keys[k][3:5] for k in ("cuda", "eager", "3 steps")] == [
            ("cuda", CHUNK), ("eager", 1), ("cuda", CHUNK - 1)]
        assert keys["cuda"][8][0] == plan != keys["tile 32"][8][0]


@pytest.mark.parametrize("user", sorted(USES))
def test_a_replay_adds_the_launches_its_capture_recorded(graphs_on_cpu,
                                                         user):
    """Five uses: the first runs uncaptured and counts its launches, the
    second captures (which counts none) and replays, and each replay adds
    what the capture recorded; nothing else is counted."""
    counts = cuda_graphs.launch_counts()
    USES[user](5)
    (c,) = graphs_on_cpu
    assert c.recorded == cuda_graphs.expect(PER_USE[user][0])
    assert cuda_graphs.launch_counts() == tuple(
        a + 5 * b for a, b in zip(counts, c.recorded))


@pytest.mark.parametrize("user", sorted(USES))
def test_a_replay_adds_the_partials_its_capture_recorded(
        graphs_on_cpu, monkeypatch, user):
    """A capture whose solve launches also counted their tile partials (as
    the kernel's wrapper does on the card, ``cuda_solve.PARTIALS``) is
    held to its launches alone; each replay adds the partials with
    them."""
    solve = cuda_solve.solve_batched

    def partials(*a, **k):
        cuda_solve.PARTIALS += 4 * a[2].shape[0]     # 4 tiles a scenario
        return solve(*a, **k)

    monkeypatch.setattr(cuda_solve, "solve_batched", partials)
    before = cuda_solve.PARTIALS
    USES[user](5)
    launches, B = PER_USE[user]
    per_use = 4 * B * launches[cuda_solve, "LAUNCHES"]
    (c,) = graphs_on_cpu
    assert c.recorded[-1] == per_use
    assert c.recorded[:-1] == cuda_graphs.expect(launches)[:-1]
    # the first use runs uncaptured and counts; the capture counts nothing
    assert cuda_solve.PARTIALS - before == 5 * per_use


@pytest.mark.parametrize("per_solve", [0, 2])
@pytest.mark.parametrize("user", ["solve", "chunk"])
def test_a_cuda_capture_without_one_launch_raises(
        graphs_on_cpu, counted_kernels, user, per_solve):
    """A capture that recorded no solve kernel launch a solve (the kernel
    left the path) or two raises, naming what it recorded and what its
    user expects, and counts nothing."""
    counted_kernels(per_solve)
    USES[user](1)
    counts = cuda_graphs.launch_counts()
    with pytest.raises(RuntimeError, match=(
            f"a captured {user} recorded .*, not cuda_solve.LAUNCHES "
            f"{PER_USE[user][0][cuda_solve, 'LAUNCHES']}, ")):
        USES[user](1)
    assert cuda_graphs.launch_counts() == counts


def _eager_use(user, monkeypatch, counter):
    """One use of ``user``'s eager program with one launch of ``counter``
    in it."""
    mod, name = counter
    owner, inner = {"solve": (psolver, "_solve_eager"),
                    "viz_rollouts": (psolver, "rollout_trajectory"),
                    "chunk": (ploop, "_eager_step")}[user]
    real = getattr(owner, inner)

    def launching(*a, **k):
        setattr(mod, name, getattr(mod, name) + 1)
        return real(*a, **k)

    monkeypatch.setattr(owner, inner, launching)
    cfg, ref, x = _cfg(), _ref(), _x0()
    state = P.init_state(cfg, device="cpu")
    eps = _eps(0, (16, 5))
    if user == "solve":
        return lambda: psolver.solve(ARM, cfg, ref, x, state, eps=eps)
    if user == "viz_rollouts":
        return lambda: psolver.viz_rollouts(ARM, cfg, x, state.u_prev,
                                            state.u_prev, eps, eps[:, 0, 0])
    return lambda: loop_chain(1, backend="eager")


@pytest.mark.parametrize("counter", [(cuda_solve, "LAUNCHES"),
                                     (cuda_step, "TAIL_LAUNCHES"),
                                     (cuda_sim, "FLEET_LAUNCHES")])
@pytest.mark.parametrize("user", ["solve", "viz_rollouts", "chunk"])
def test_an_eager_capture_with_a_port_kernel_launch_raises(
        graphs_on_cpu, monkeypatch, user, counter):
    """The eager backend and the re-rollouts never run a port kernel: a
    capture that records one raises, naming it, and leaves every count as
    it found it."""
    use = _eager_use(user, monkeypatch, counter)
    use()
    counts = cuda_graphs.launch_counts()
    mod, name = counter
    with pytest.raises(RuntimeError, match=(
            f"a captured {user} recorded {mod.__name__.rsplit('.', 1)[1]}."
            rf"{name} \d, not no kernel launch")):
        use()
    assert cuda_graphs.launch_counts() == counts


# ---- no host reads ---------------------------------------------------------------

@contextlib.contextmanager
def host_reads_raise():
    """Every host read of a tensor, and every tensor made from host data,
    raises within the block, as in a capture on the card."""
    def host_read(self, *a, **k):
        raise AssertionError("the captured call read a tensor on the host")

    saved = [(torch.Tensor, a, getattr(torch.Tensor, a))
             for a in ("__bool__", "__int__", "__float__", "__index__",
                       "item", "tolist")]
    saved += [(torch, a, getattr(torch, a)) for a in ("tensor", "as_tensor")]
    try:
        for owner, attr, _ in saved[:-2]:
            setattr(owner, attr, host_read)
        for owner, attr, made in saved[-2:]:
            def from_tensors_only(data, *a, _made=made, **k):
                if not isinstance(data, torch.Tensor):
                    raise AssertionError("the captured call copied host "
                                         "data")
                return _made(data, *a, **k)
            setattr(owner, attr, from_tensors_only)
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


@pytest.mark.parametrize("chain", ["solve eager eps", "viz"])
def test_a_captured_call_reads_nothing_from_the_host(graphs_on_cpu,
                                                     monkeypatch, chain):
    """The program a capture records, and each replay of it, run with
    every host read raising; the call's host part (the checks, the
    tensors made from its scalars) runs outside."""
    capture = cuda_graphs.capture

    def guarded(program, *a, **k):
        def strict():
            with host_reads_raise():
                return program()
        return capture(strict, *a, **k)

    dtype = torch.float64
    with cuda_graphs.uncaptured():
        solved = solve_chain("eager", "eps", dtype, calls=4)
        want = solved if chain != "viz" else viz_chain(solved, dtype)
    monkeypatch.setattr(cuda_graphs, "capture", guarded)
    got = (solve_chain("eager", "eps", dtype, calls=4) if chain != "viz"
           else viz_chain(solved, dtype))
    assert_same(got, want)
    assert len(graphs_on_cpu) == 1 and len(psolver._CALL_GRAPHS) == 1


# ---- the compat drop-in against the JAX package ------------------------------------

RUN_CFG = dict(  # the run.py:25-37 call-site values
    delta_t=0.006, horizon_step_T=30, number_of_samples_K=100,
    param_exploration=0.0, param_lambda=100.0, param_alpha=0.98,
    sigma=np.array([[20.0, 0.0], [0.0, 20.0]]),
    stage_cost_weight=np.array([0.5, 0.5, 5.0, 5.0]),
    terminal_cost_weight=np.array([5.0, 5.0, 50.0, 50.0]))


@pytest.mark.skipif(jcompat is None, reason="needs the JAX package")
def test_compat_through_the_graphs_matches_jax(graphs_on_cpu):
    """20 calls of the drop-in, visualisation on, through the graphs in
    float64, against the JAX package's compat layer on its xla backend,
    both drawing the same NumPy stream; the plant is stepped with JAX's
    control so both see the same observations."""
    from mppi_robotarm_tpu_torch.compat import (
        Arm_Dynamic, MPPIControllerForPathTracking)

    ref = P.synth_circle_path(2000, dtype=np.float64)
    mine = MPPIControllerForPathTracking(
        ref_path=ref, visualize_optimal_traj=True,
        visualze_sampled_trajs=True, rng=np.random.default_rng(7),
        backend="eager", device="cpu", **RUN_CFG)
    theirs = jcompat.MPPIControllerForPathTracking(
        ref_path=ref, visualize_optimal_traj=True,
        visualze_sampled_trajs=True, rng=np.random.default_rng(7),
        backend="xla", **RUN_CFG)
    q, dq = np.array([1.1522, -1.2661]), np.zeros(2)
    for step in range(20):
        obs = np.concatenate([q, dq])
        got = mine.calc_control_input(obs)
        want = theirs.calc_control_input(obs)
        for k, a, b in zip(("u0", "u_seq", "optimal_traj", "sampled"), got,
                           want):
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                       err_msg=f"step {step} {k}")
        assert mine.prev_waypoints_idx == theirs.prev_waypoints_idx
        dq = dq + 0.003 * Arm_Dynamic(q, dq, want[0])
        q = q + 0.003 * dq
    assert sorted(k[0] for k in psolver._CALL_GRAPHS) == ["solve",
                                                          "viz_rollouts"]
    assert len(graphs_on_cpu) == 2


# ---- on the card ----------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs replay on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chain", sorted(CHAINS) + ["viz"])
def test_graphs_equal_the_uncaptured_calls_on_the_card(dev, monkeypatch,
                                                       chain, dtype):
    monkeypatch.setattr(psolver, "_CALL_GRAPHS", type(
        psolver._CALL_GRAPHS)())
    if chain == "viz":
        with cuda_graphs.uncaptured():
            solved = solve_chain("eager", "eps", dtype, device=dev)
        run = lambda: viz_chain(solved, dtype, device=dev)
    else:
        run = lambda: CHAINS[chain](dtype, device=dev)
    counts = cuda_graphs.launch_counts()
    with cuda_graphs.uncaptured():
        want = run()
    between = cuda_graphs.launch_counts()
    got = run()
    assert_same(got, want, chain)
    (g,) = psolver._CALL_GRAPHS.values()
    assert g.captured is not None
    # the graph path launches what the uncaptured calls launch
    after = cuda_graphs.launch_counts()
    assert [a - b for a, b in zip(after, between)] == [
        b - c for b, c in zip(between, counts)]


@pytest.mark.cuda
def test_compat_graphs_equal_uncaptured_on_the_card(dev):
    from mppi_robotarm_tpu_torch.tools import call_graphs

    for backend in ("cuda", "eager"):
        psolver._CALL_GRAPHS.clear()
        got = call_graphs.compat_run(backend, dev, 30, True)
        want = call_graphs.compat_run(backend, dev, 30, False)
        assert set(call_graphs.compat_bits(got, want).values()) == {0.0}
    psolver._CALL_GRAPHS.clear()


@pytest.mark.cuda
def test_back_to_back_seeded_solves_equal_the_uncaptured_on_the_card(dev):
    """200 seeded solves with no read between, each with its own seed and
    step, each fed the last one's state: the pinned buffer is not
    rewritten while an earlier call's copy is queued."""
    cfg = _cfg(K=1024, T=50)
    ref, x0 = _ref(device=dev), _x0(device=dev)

    def chain():
        state, x, out = P.init_state(cfg, device=dev), x0, []
        for i in range(200):
            res = psolver.solve(ARM, cfg, ref, x, state, backend="cuda",
                                seed=1_000_003 * i + 11, step=i)
            out.append(res)
            state, x = res.state, _next_x(x, res.u0)
        return out

    psolver._CALL_GRAPHS.clear()
    with cuda_graphs.uncaptured():
        want = chain()
    replays = psolver.REPLAYS
    got = chain()
    torch.cuda.synchronize(dev)
    assert_same(got, want)
    assert psolver.REPLAYS - replays == 198
    psolver._CALL_GRAPHS.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "eager"])
def test_a_path_written_without_a_version_bump_is_seen_on_the_card(
        dev, backend):
    cfg = _cfg(exploration=0.25)
    ref, x = _ref(device=dev), _x0(device=dev)
    state = P.init_state(cfg, device=dev)
    eps = _eps(0, (16, 5), device=dev)
    kw = dict(seed=5, step=2) if backend == "cuda" else dict(eps=eps)
    call = lambda: psolver.solve(ARM, cfg, ref, x, state, backend=backend,
                                 **kw)
    psolver._CALL_GRAPHS.clear()
    for _ in range(3):
        before = call()
    version = ref._version
    ref.data.add_(0.05)
    assert ref._version == version
    got = call()
    with cuda_graphs.uncaptured():
        want = call()
    assert_same(got, want)
    assert not torch.equal(got.costs, before.costs)
    (g,) = psolver._CALL_GRAPHS.values()
    assert g.captured is not None
    psolver._CALL_GRAPHS.clear()
