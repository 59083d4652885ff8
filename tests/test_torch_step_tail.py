"""The per-step loop's step body around the solve kernel
(``ops/cuda_step.py``): the step head (observed state, waypoint advance,
window) and the step tail (freeze, warm-start shift, plant, step counter,
record row).

On the CPU, through the plain versions:
* the head and the tail against the JAX package's functions of a step in
  float64 (``fk_ee`` + ``update_waypoint_index`` vmapped, as
  ``solve_batched_pallas`` runs them; ``plant_step``, the freeze of
  ``sim_step`` and the record row of ``simulate``'s scan body), to 1e-12;
* the plain step against :func:`old_step`, a copy of the step body the
  kernels replaced (``sim/loop.py::_step_batch`` with its plant and freeze,
  the record statistics of ``_steps_into`` and the record's FK, reference
  rows and zeroing), bit for bit, with frozen scenarios and the path end
  among them;
* a 40-step eps-mode run of ``simulate`` and ``simulate_batch`` (cuda
  backend) against a loop of the JAX package's ``sim_step(backend='xla')``,
  in the bands of tests/test_torch_batch.py (q within 2e-6·4^i and u
  within 2e-5·4^i at step i, index and done equal over its 8 steps), and
  each of the 40 steps alone from JAX's state in the bands of step 0.

Marked ``cuda`` and skipped without a card: each kernel against its plain
version on the same inputs on the card, B = 1 and 64 with frozen scenarios
and the path end: the head bit for bit; the tail's state, controls, index,
done, FK and reference row bit for bit, min S bit for bit and the mean,
ESS and entropy within 2e-6 relative, the entropy's relative to at least
its range log K (the kernel sums over K in another order, and a
near-deterministic softmax has an entropy near 0, where one rounding of a
weight near 1 is a large share of it); the head the tail carries equal to
the head kernel's on the tail's outputs; the graph loop's launches (a head
a chunk, a tail a step); and float64 card tensors through the kernels (the
head, the tail, ``simulate_batch`` and ``solve``), which give the float32
run's bits, cast.  The file imports JAX inside a
``try``, so on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_step_tail.py -m cuda
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.models.arm import fk_full
from mppi_robotarm_tpu_torch.mppi import solver
from mppi_robotarm_tpu_torch.ops import cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.ops.weights import (effective_sample_size,
                                                 mppi_weights, weight_entropy)
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.utils import cuda_graphs

try:                                     # the CPU parity tests' reference
    import jax
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    import mppi_robotarm_tpu.sim.loop as jloop
    from mppi_robotarm_tpu.models.arm import fk_ee as jfk_ee
    from mppi_robotarm_tpu.models.arm import fk_full as jfk_full
    from mppi_robotarm_tpu.ops.waypoint import (
        update_waypoint_index as jupdate)
    from mppi_robotarm_tpu.ops.weights import (
        effective_sample_size as jess, mppi_weights as jweights,
        weight_entropy as jentropy)
except ImportError:                      # the GPU machine has no JAX
    J = None

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()
F32, F64 = torch.float32, torch.float64
Q_TOL, U_TOL = 2e-6, 2e-5                # tests/test_torch_batch.py's bands
U_RTOL = 2e-5                            # and its one solve's costs, relative
STATS_RTOL = 2e-6                        # the kernel's sums over K, relative


def needs_jax():
    if J is None:
        pytest.skip("the CPU parity tests need the JAX package")


def _cfg(K=48, T=8):
    return dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T)


def _arc(dtype=F32, device="cpu"):
    """A 40-waypoint arc whose end the loop reaches in about 50 steps."""
    return torch.as_tensor(P.synth_circle_path(40, revolutions=0.02),
                           dtype=dtype, device=device)


def _inputs(cfg, B, dtype=F32, device="cpu", seed=0, ref=None):
    """A step's inputs for B scenarios on ``ref`` (default :func:`_arc`):
    states spread over the path (the last two near its end), a third of
    them frozen, and a solve's outputs made with NumPy from ``seed``:
    (ref, state tensors (step, q, dq, u_prev, wp_idx, done), clock, u_seq,
    s)."""
    rng = np.random.default_rng(seed)
    ref = _arc(dtype, device) if ref is None else ref
    n_ref = ref.shape[0]
    g = lambda *s, scale=1.0: torch.as_tensor(
        rng.normal(size=s) * scale, dtype=dtype, device=device)
    q = torch.as_tensor(np.array([SIM.q0]) + 0.05 * rng.normal(size=(B, 2)),
                        dtype=dtype, device=device)
    wp = torch.as_tensor(rng.integers(0, n_ref - 3, size=B), device=device)
    wp[-2:] = torch.tensor([n_ref - 3, n_ref - 2])[:min(B, 2)]
    done = torch.as_tensor(np.arange(B) % 3 == 1, device=device)
    step = torch.as_tensor(rng.integers(0, 50, size=B), device=device)
    clock = step + torch.as_tensor(rng.integers(0, 9, size=B), device=device)
    state = (step, q, g(B, 2, scale=0.3), g(B, cfg.horizon, 2, scale=5.0),
             wp, done)
    s = torch.as_tensor(rng.uniform(50.0, 900.0, size=(B, cfg.num_samples)),
                        dtype=dtype, device=device)
    return ref, state, clock, g(B, cfg.horizon, 2, scale=5.0), s


def _row(B, dtype, ref_dtype, device="cpu"):
    e = lambda dt, *s: torch.empty((B, *s), dtype=dt, device=device)
    return (e(dtype, 2), e(dtype, 2), e(dtype, 2), e(dtype, 2), e(dtype, 2),
            e(ref_dtype, 2), e(torch.int64), e(dtype), e(dtype), e(dtype),
            e(dtype), e(torch.bool))


def old_step(arm, cfg, sim, ref, state, clock, u_seq, s, wp_new, path_end):
    """The step body the kernels replaced, as ``sim/loop.py`` ran it:
    ``_step_batch``'s shift, weights, plant and freeze, ``_steps_into``'s
    record statistics, and the record's FK, reference rows and zeroing,
    which ``_step_loop`` applied to all rows after the run (as ``_record``
    does to one scenario's)."""
    step, q, dq, u_prev, wp_idx, done = state
    u_next = solver.shift_warm_start(u_seq)
    weights = mppi_weights(s, cfg.lam)
    done = done | path_end
    q_new, dq_new = ploop.plant_step(arm, sim, q, dq, u_next[:, 0])
    keep = lambda new, old: torch.where(
        done.view(-1, *(1,) * (new.dim() - 1)), old, new)
    nxt = (step + torch.where(done, 0, 1), keep(q_new, q), keep(dq_new, dq),
           keep(u_next, u_prev), keep(wp_new, wp_idx), done)
    x1, y1, x2, y2 = fk_full(nxt[1][..., 0], nxt[1][..., 1], arm)
    idx = torch.clamp(clock + 1, max=ref.shape[0] - 1)
    zero = lambda v: torch.where(done.view(-1, *(1,) * (v.dim() - 1)),
                                 torch.zeros_like(v), v)
    return nxt, (nxt[1], nxt[2], zero(u_next[:, 0]),
                 torch.stack([x2, y2], dim=-1), torch.stack([x1, y1], dim=-1),
                 ref[idx, 0:2], nxt[4], zero(torch.amin(s, dim=-1)),
                 zero(torch.mean(s, dim=-1)),
                 zero(effective_sample_size(weights)),
                 zero(weight_entropy(weights)), done)


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_plain_step_equals_the_old_step_body(B, dtype):
    """Head, then the tail with a record row, against :func:`old_step` on
    the head's index and path end: equal bit for bit, frozen scenarios
    and the path end included (the last two scenarios start two rows and
    one row before it)."""
    cfg = _cfg()
    ref, state, clock, u_seq, s = _inputs(cfg, B, dtype)
    x0, wp_new, path_end, window = cuda_step.step_head(
        cfg, ref, state[1], state[2], state[4])
    assert torch.equal(x0, torch.cat([state[1], state[2]], dim=-1))
    if B > 1:
        assert bool(path_end.any())
    row = _row(B, dtype, ref.dtype)
    got = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new, path_end,
                              u_seq, s, clock, row)
    want, want_row = old_step(ARM, cfg, SIM, ref, state, clock, u_seq, s,
                              wp_new, path_end)
    for name, a, b in zip(("step", "q", "dq", "u_prev", "wp", "done"), got,
                          want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert torch.equal(got[6], clock + 1)
    for name, a, b in zip(P.SimRecord._fields, row, want_row):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_plain_tail_without_a_row_or_clock():
    """``sim_step``'s tail: no record row, no clock; a row without a clock
    is refused on the card (the reference row needs it)."""
    cfg = _cfg()
    ref, state, clock, u_seq, s = _inputs(cfg, 3)
    _, wp_new, path_end, _ = cuda_step.step_head(cfg, ref, state[1],
                                                 state[2], state[4])
    got = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new, path_end,
                              u_seq, s)
    with_row = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new,
                                   path_end, u_seq, s, clock,
                                   _row(3, F32, F32))
    assert got[6] is None
    for a, b in zip(got[:6], with_row[:6]):
        assert torch.equal(a, b)


def test_head_and_tail_match_the_jax_step_in_float64():
    """The JAX package's functions of one step, vmapped over the batch,
    in float64: the head's index, path end and window exactly, the tail's
    state and record row to 1e-12."""
    needs_jax()
    cfg = _cfg(64, 10)
    jcfg = J.MPPIConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})
    B = 6
    ref, state, clock, u_seq, s = _inputs(cfg, B, F64, seed=3)
    step, q, dq, u_prev, wp, done = state
    x0, wp_new, path_end, window = cuda_step.step_head(cfg, ref, q, dq, wp)
    jref = jnp.asarray(ref.numpy())

    def jhead(w, obs):
        x, y = jfk_ee(obs[0], obs[1], jcfg.l1, jcfg.l2)
        return jupdate(jref, w, x, y, jcfg.search_idx_len, jcfg.dist_scale)

    jw, jwin, _ = jax.vmap(jhead)(jnp.asarray(wp.numpy()),
                                  jnp.asarray(x0.numpy()))
    np.testing.assert_array_equal(wp_new.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(path_end.numpy(),
                                  np.asarray(jw) >= ref.shape[0] - 1)
    np.testing.assert_array_equal(window.numpy(), np.asarray(jwin))

    row = _row(B, F64, F64)
    got = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new, path_end,
                              u_seq, s, clock, row)
    jarm, jsim = J.ArmParams(), J.SimConfig()
    jdone = np.asarray(done.numpy() | path_end.numpy())
    jnext = np.concatenate([np.asarray(u_seq.numpy())[:, 1:],
                            np.asarray(u_seq.numpy())[:, -1:]], axis=1)
    qn, dqn = jax.vmap(lambda a, b_, c: jloop.plant_step(
        jarm, jsim, a, b_, c))(jnp.asarray(q.numpy()),
                              jnp.asarray(dq.numpy()),
                              jnp.asarray(jnext[:, 0]))
    keep = lambda new, old: np.where(
        jdone.reshape(-1, *(1,) * (np.ndim(new) - 1)), old, new)
    q_want = keep(np.asarray(qn), q.numpy())
    np.testing.assert_allclose(got[1].numpy(), q_want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[2].numpy(),
                               keep(np.asarray(dqn), dq.numpy()), atol=1e-12)
    np.testing.assert_array_equal(got[3].numpy(), keep(jnext, u_prev.numpy()))
    np.testing.assert_array_equal(got[4].numpy(),
                                  keep(wp_new.numpy(), wp.numpy()))
    np.testing.assert_array_equal(got[0].numpy(),
                                  step.numpy() + (~jdone).astype(np.int64))
    x1, y1, x2, y2 = jfk_full(jnp.asarray(q_want[:, 0]),
                              jnp.asarray(q_want[:, 1]), jarm)
    w = jax.vmap(lambda c: jweights(c, jcfg.lam))(jnp.asarray(s.numpy()))
    zero = lambda v: np.where(jdone.reshape(-1, *(1,) * (np.ndim(v) - 1)),
                              0.0, np.asarray(v))
    want = {"ee": np.stack([x2, y2], -1), "elbow": np.stack([x1, y1], -1),
            "ref_xy": ref.numpy()[np.minimum(clock.numpy() + 1,
                                             ref.shape[0] - 1), 0:2],
            "u": zero(jnext[:, 0]), "cost_min": zero(s.numpy().min(-1)),
            "cost_mean": zero(s.numpy().mean(-1)),
            "ess": zero(jax.vmap(jess)(w)),
            "weight_entropy": zero(jax.vmap(jentropy)(w))}
    rec = dict(zip(P.SimRecord._fields, row))
    for name, v in want.items():
        np.testing.assert_allclose(rec[name].numpy(), v, rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(rec["done"].numpy(), jdone)


@pytest.mark.parametrize("batch", [False, True])
def test_forty_eps_steps_match_the_jax_xla_loop(ref_path, batch):
    """``simulate`` (B=1) or ``simulate_batch`` (B=3) with the cuda backend
    on CPU tensors, on injected noise, against a loop of JAX's
    ``sim_step(backend='xla')`` over 40 steps.

    The closed loop: q and u in the bands at every step, index and done
    equal over the first 8 steps (tests/test_torch_batch.py's run), the
    reference rows and FK exact.  Later the two loops part: the port rolls
    out with the trig carry, JAX with direct trig, and by step 12 their q
    differ by ~2e-4 and their indices by a row, as they did before the
    step kernels.  So each of the 40 steps is also run alone from JAX's
    state: one port step must give JAX's next state in the bands of step
    0, u also within 2e-5 relative (controls of 10-15 differ by up to 2.6e-5
    after one solve; test_torch_batch.py holds one solve's costs to 2e-5
    relative), and its index and done."""
    needs_jax()
    from _torch_port_helpers import configs, eps_noise

    cj, cp = configs(96, 10)
    steps, B = 40, 3 if batch else 1
    ref = np.asarray(ref_path, np.float32)
    eps = eps_noise(40, (steps, 96, 10, 2))
    jarm, jsim = J.ArmParams(), J.SimConfig()
    js = J.init_sim(cj, jsim, jax.random.PRNGKey(0), dtype=jnp.float32)
    jstates = [js]
    for i in range(steps):
        js, _ = jloop.sim_step(jarm, cj, jsim, jnp.asarray(ref), js,
                               eps=jnp.asarray(eps[i]), backend="xla")
        jstates.append(js)
    ref_t, eps_t = torch.as_tensor(ref), torch.as_tensor(eps)

    def run(state, n, noise):
        """n port steps from a single-scenario state, as a batch of B."""
        if not batch:
            _, r = P.simulate(ARM, cp, SIM, ref_t, state, n,
                              eps_per_step=noise, backend="cuda")
            return P.SimRecord(*(f[:, None] for f in r))
        rows = lambda v: torch.as_tensor(v).expand(B, *v.shape).clone()
        states = P.init_sim_batch(cp, SIM, [state.seed] * B, device="cpu")
        states = states._replace(
            step=rows(state.step), q=rows(state.q), dq=rows(state.dq),
            mppi=P.MPPIState(rows(state.mppi.u_prev),
                             rows(state.mppi.wp_idx)),
            done=rows(state.done))
        _, r = P.simulate_batch(ARM, cp, SIM, ref_t, states, n,
                                eps_per_step=noise[:, None].expand(
                                    n, B, *noise.shape[1:]),
                                backend="cuda")
        return r

    def agree(rec, i, js, q_tol, u_tol, exact, u_rtol=0.0):
        for b in range(B):
            np.testing.assert_allclose(rec.q[i, b].numpy(), np.asarray(js.q),
                                       atol=q_tol, err_msg=f"q {i}")
            np.testing.assert_allclose(rec.u[i, b].numpy(),
                                       np.asarray(js.mppi.u_prev[0]),
                                       rtol=u_rtol, atol=u_tol,
                                       err_msg=f"u {i}")
            if exact:
                assert int(rec.wp_idx[i, b]) == int(js.mppi.wp_idx), i
                assert bool(rec.done[i, b]) == bool(js.done), i

    rec = run(P.init_sim(cp, SIM, 0, device="cpu"), steps, eps_t)
    for i in range(steps):
        agree(rec, i, jstates[i + 1], Q_TOL * 4 ** i, U_TOL * 4 ** i, i < 8)
    np.testing.assert_array_equal(rec.ref_xy[:, 0].numpy(),
                                  ref[1:steps + 1, :2])
    x1, y1, x2, y2 = fk_full(rec.q[..., 0], rec.q[..., 1], ARM)
    assert torch.equal(rec.ee, torch.stack([x2, y2], dim=-1))
    assert torch.equal(rec.elbow, torch.stack([x1, y1], dim=-1))

    for i in range(steps):
        js = jstates[i]
        start = P.init_sim(cp, SIM, 0, device="cpu")._replace(
            step=torch.tensor(i), q=torch.as_tensor(np.asarray(js.q)),
            dq=torch.as_tensor(np.asarray(js.dq)),
            mppi=P.MPPIState(torch.as_tensor(np.asarray(js.mppi.u_prev)),
                             torch.tensor(int(js.mppi.wp_idx))),
            done=torch.tensor(bool(js.done)))
        one = run(start, 1, eps_t[i:i + 1])
        agree(one, 0, jstates[i + 1], Q_TOL, U_TOL, True, U_RTOL)


def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrappers dispatch on where the tensors lie: all on the CPU takes
    the plain version, anything on the card the kernel (here a stand-in
    that records the call), never the plain version."""
    calls = []
    monkeypatch.setattr(cuda_step, "_head_launch",
                        lambda *a: calls.append("head"))
    monkeypatch.setattr(cuda_step, "_tail_launch",
                        lambda *a: calls.append("tail"))
    monkeypatch.setattr(cuda_step, "step_head_plain",
                        lambda *a: pytest.fail("plain head on the card"))
    monkeypatch.setattr(cuda_step, "step_tail_plain",
                        lambda *a: pytest.fail("plain tail on the card"))
    cfg = _cfg()
    ref, state, clock, u_seq, s = _inputs(cfg, 2)
    meta = torch.empty(2, device="meta")     # stands for a tensor elsewhere
    cuda_step.step_head(cfg, ref, state[1], state[2], meta)
    cuda_step.step_tail(ARM, cfg, SIM, ref, *state, meta, state[5], u_seq,
                        s, clock)
    assert calls == ["head", "tail"]


@pytest.mark.parametrize("K", [1, 31, 32, 100, 1024, 1025, 65536])
def test_tail_threads_depend_on_k_alone(K):
    n = cuda_step.step_tail_threads(K)
    assert n % 32 == 0 and 32 <= n <= cuda_step.MAX_THREADS
    assert n >= min(K, cuda_step.MAX_THREADS)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step kernels run on the card")
    return torch.device("cuda", 0)


def _kernel_vs_plain(cfg, B, dev, seed, ref=None):
    """The head and the tail on the card against their plain versions on
    the same card tensors; returns the largest relative error of the
    statistics after asserting every other output bit for bit."""
    ref, state, clock, u_seq, s = _inputs(cfg, B, F32, dev, seed, ref)
    got_h = cuda_step._head_launch(cfg, ref, state[1], state[2], state[4])
    want_h = cuda_step.step_head_plain(cfg, ref, state[1], state[2],
                                       state[4])
    for name, a, b in zip(("x0", "wp", "path_end", "window"), got_h, want_h):
        assert torch.equal(a, b), name
    _, wp_new, path_end, _ = want_h
    rows = [_row(B, F32, F32, dev) for _ in range(2)]
    got = cuda_step._tail_launch(ARM, cfg, SIM, ref, state, wp_new,
                                 path_end, u_seq, s, clock, rows[0])
    want = cuda_step.step_tail_plain(ARM, cfg, SIM, ref, *state, wp_new,
                                     path_end, u_seq, s, clock, rows[1])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    err = 0.0
    for name, a, b in zip(P.SimRecord._fields, *rows):
        if name in ("cost_mean", "ess", "weight_entropy"):
            floor = (math.log(cfg.num_samples) if name == "weight_entropy"
                     else 1e-30)
            rel = ((a - b).abs() / b.abs().clamp_min(floor)).max().item()
            assert rel <= STATS_RTOL, (name, rel)
            err = max(err, rel)
        else:
            assert torch.equal(a, b), name
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,B", [(1024, 50, 1), (1024, 50, 64),
                                   (128, 30, 64), (100, 30, 8),
                                   (2000, 10, 3)])
def test_kernels_equal_their_plain_versions(dev, K, T, B):
    cfg = _cfg(K, T)
    for seed in range(3):
        _kernel_vs_plain(cfg, B, dev, seed)
    long_ref = torch.as_tensor(P.synth_circle_path(8000), device=dev)
    _kernel_vs_plain(cfg, B, dev, 7, long_ref)


@pytest.mark.cuda
def test_graph_loop_runs_one_head_and_one_tail_a_step(dev, monkeypatch):
    """A chunk of n steps launches one step head, then a solve and a tail
    a step, n - 1 of the tails carrying the next step's head: a head a
    chunk, a tail and a solve a step."""
    monkeypatch.setattr(ploop, "_GRAPHS", type(ploop._GRAPHS)())
    cfg = _cfg(512, 16)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    states = P.init_sim_batch(cfg, SIM, [1, 2], device=dev)
    steps = 2 * ploop._GRAPH_STEPS + 3
    chunks = -(-steps // ploop._GRAPH_STEPS)
    for _ in range(2):
        before = (cuda_step.HEAD_LAUNCHES, cuda_step.TAIL_LAUNCHES,
                  cuda_step.CARRIED_HEADS, cuda_solve.LAUNCHES)
        P.simulate_batch(ARM, cfg, SIM, ref, states, steps, backend="cuda")
        torch.cuda.synchronize()
        assert (cuda_step.HEAD_LAUNCHES - before[0],
                cuda_step.TAIL_LAUNCHES - before[1],
                cuda_step.CARRIED_HEADS - before[2],
                cuda_solve.LAUNCHES - before[3]) == (
                    chunks, steps, steps - chunks, steps)
    for key, e in ploop._GRAPHS.items():
        n = key[4]                          # the chunk's steps
        assert e.captured.recorded[:-1] == cuda_graphs.expect({
            (cuda_solve, "LAUNCHES"): n, (cuda_step, "HEAD_LAUNCHES"): 1,
            (cuda_step, "TAIL_LAUNCHES"): n,
            (cuda_step, "CARRIED_HEADS"): n - 1})[:-1]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64])
def test_carried_head_equals_the_head_kernel_on_the_tail_outputs(dev, B):
    """The tail's carried head (x0, index, path end, window) against
    ``step_head_kernel`` run on the tail's q, dq and index, bit for bit,
    with frozen scenarios and the path end among them; the tail's other
    outputs are those of the tail that carries no head."""
    cfg = _cfg(1024, 50)
    for seed in range(3):
        ref, state, clock, u_seq, s = _inputs(cfg, B, F32, dev, seed)
        _, wp_new, path_end, _ = cuda_step.step_head(cfg, ref, state[1],
                                                     state[2], state[4])
        rows = [_row(B, F32, F32, dev) for _ in range(2)]
        *got, head = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new,
                                         path_end, u_seq, s, clock, rows[0],
                                         carry_head=True)
        want = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new,
                                   path_end, u_seq, s, clock, rows[1])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(*rows))
        if B > 1:
            assert bool(got[5].any()) and not bool(got[5].all())
            assert bool((got[4] >= ref.shape[0] - 3).any())
        ref_head = cuda_step._head_launch(cfg, ref, got[1], got[2], got[4])
        for name, a, b in zip(("x0", "wp", "path_end", "window"), head,
                              ref_head):
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
def test_float64_on_the_card_runs_in_float32(dev):
    """float64 card tensors go through the kernels in float32 and come back
    in float64: the head, the tail with its record row, the per-step loop
    and solve() give the float32 run's bits, cast."""
    d = lambda t: t.double() if t.is_floating_point() else t
    same = lambda a, b: b.dtype == d(a).dtype and torch.equal(d(a), b)
    cfg = _cfg(128, 16)
    ref, state, clock, u_seq, s = _inputs(cfg, 4, F32, dev, 0)
    h32 = cuda_step.step_head(cfg, ref, state[1], state[2], state[4])
    h64 = cuda_step.step_head(cfg, d(ref), d(state[1]), d(state[2]),
                              state[4])
    assert all(same(a, b) for a, b in zip(h32, h64))
    rows = _row(4, F32, F32, dev), _row(4, F64, F64, dev)
    t32 = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, h32[1], h32[2],
                              u_seq, s, clock, rows[0])
    t64 = cuda_step.step_tail(ARM, cfg, SIM, d(ref), *map(d, state),
                              h32[1], h32[2], d(u_seq), d(s), clock, rows[1])
    assert all(same(a, b) for a, b in zip((*t32, *rows[0]),
                                          (*t64, *rows[1])))
    path = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    st = P.init_sim_batch(cfg, SIM, [1, 2], device=dev)
    st64 = ploop._as_state(tuple(map(d, ploop._state_tensors(st))))
    for steps in (3, ploop._GRAPH_STEPS + 2):
        (f32, r32), (f64, r64) = (
            P.simulate_batch(ARM, cfg, SIM, path, st, steps, backend="cuda"),
            P.simulate_batch(ARM, cfg, SIM, path.double(), st64, steps,
                             backend="cuda"))
        assert all(same(a, b) for a, b in zip(ploop._state_tensors(f32),
                                              ploop._state_tensors(f64)))
        assert all(same(a, b) for a, b in zip(r32, r64))
    x = torch.tensor([*SIM.q0, *SIM.dq0], device=dev)
    one = [P.solve(ARM, cfg, p, x.to(p.dtype), P.init_state(
        cfg, p.dtype, dev), backend="cuda", seed=5, step=2)
        for p in (path, path.double())]
    for f in ("u0", "u_seq", "path_end", "costs"):
        assert same(getattr(one[0], f), getattr(one[1], f)), f
    assert same(one[0].state.wp_idx, one[1].state.wp_idx)
