"""The sharded programs of the port (``parallel/``) against the JAX package's
(``mppi_robotarm_tpu/parallel/``) on the suite's 8-device CPU mesh, with
the same NumPy-made inputs, and as real multi-process gloo runs.

* Bring-up: the environment detection and the init failure policy, as
  ``tests/test_sharding.py`` and ``tests/test_distributed.py`` hold JAX's.
* One process: each rank of a (data, samples) mesh is a thread with the
  mesh coordinates of its rank and an in-process all-reduce (the
  collectives' semantics: every shard gets the reduction of all shards'
  tensors, summed in shard order).  Eager backend against JAX's xla in
  float64 to 1e-12; the cuda backend on CPU tensors (the solve kernel's
  plain twin) against JAX's pallas kernel in interpret mode in float32,
  within the kernel's bands (costs rtol 2e-5); the closed-loop step with
  JAX's folded threefry draws injected; the fleet against JAX's in
  phase 2's bands (q within 2e-6·4^i, u within 2e-5·4^i at step i).
* Processes: ``parallel/dryrun.py --device cpu`` at 2 and 4 ranks, whose
  blocks equal the one-process results bit for bit (with two sample
  shards a sum has two terms, so its order cannot differ).

The cuda-marked tests at the end are the card's twins of chip_smoke's
phases 16-17; they import nothing of JAX, so on a GPU machine without JAX

    python -m pytest --noconftest tests/test_torch_parallel.py -m cuda
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import _build, cuda_solve
from mppi_robotarm_tpu_torch.ops.weights import mppi_weights
from mppi_robotarm_tpu_torch.parallel import dryrun, mesh as pmesh
from mppi_robotarm_tpu_torch.parallel import sharded as psh
from mppi_robotarm_tpu_torch.sim import loop as ploop

try:        # the GPU machine has no JAX: there only the cuda tests run
    import jax
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    from mppi_robotarm_tpu.ops.noise import sample_epsilon, sigma_cholesky
    from mppi_robotarm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mppi_robotarm_tpu.parallel import sharded as jsh
    from _torch_port_helpers import configs, eps_noise, n, t
except ImportError:
    jax = None

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARM, PSIM = P.ArmParams(), P.SimConfig()
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0])
F32, F64 = torch.float32, torch.float64
Q_TOL, U_TOL = 2e-6, 2e-5


class FakeMesh:
    """The (data, samples) coordinates of one rank, with the DeviceMesh
    calls the sharded programs make."""

    mesh_dim_names = (pmesh.DATA_AXIS, pmesh.SAMPLES_AXIS)

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


class ThreadReduce:
    """An all-reduce across the threads of one 'samples' group."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=120)
        self.slots = [None] * n

    def member(self, r):
        def reduce(x, op):
            self.slots[r] = x.clone()
            self.barrier.wait()
            out = self.slots[0]
            for v in self.slots[1:]:
                out = torch.minimum(out, v) if op == "min" else out + v
            self.barrier.wait()
            return x.copy_(out)
        return reduce


def run_mesh(shape, body):
    """``body(mesh, reduce)`` on every rank of a ``shape`` mesh, a thread
    a rank; returns the results as [data][samples]."""
    D, S = shape
    out = [[None] * S for _ in range(D)]
    errors = []

    def rank(d, s, reduce):
        try:
            out[d][s] = body(FakeMesh(shape, (d, s)), reduce)
        except BaseException as e:        # re-raised in the test's thread
            errors.append(e)
            red.barrier.abort()

    for d in range(D):
        red = ThreadReduce(S)
        threads = [threading.Thread(target=rank, args=(d, s, red.member(s)))
                   for s in range(S)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive(), "a rank did not finish"
    if errors:
        raise errors[0]
    return out


def blocks(x, shape, d, s=None):
    """Rank (d, s)'s block of a full (B, K, ...) array: rows of data block
    d, and with ``s`` the samples of shard s."""
    D, S = shape
    b = x.shape[0] // D
    x = x[d * b:(d + 1) * b]
    if s is None:
        return x
    k = x.shape[1] // S
    return x[:, s * k:(s + 1) * k]


def gather(out, shape, i, sample_axis):
    """Output ``i`` of every rank as the full array: data blocks stacked,
    and along the sample axis the shards concatenated (else shard 0's,
    which all shards hold)."""
    rows = []
    for d in range(shape[0]):
        if sample_axis:
            rows.append(torch.cat([out[d][s][i] for s in range(shape[1])],
                                  dim=1))
        else:
            rows.append(out[d][0][i])
    return torch.cat(rows).numpy()


# ---- bring-up --------------------------------------------------------------

def test_detect_multihost_env():
    """The environment parsing, without a cluster (as test_sharding.py
    holds JAX's): MPPI_* first, then torchrun's names."""
    detect = pmesh.detect_multihost_env
    assert detect({}) == (None, None, None)
    assert detect({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234",
                   "WORLD_SIZE": "4", "RANK": "2"}) == ("10.0.0.1:1234", 4, 2)
    assert detect({"MPPI_COORDINATOR_ADDRESS": "h0:99",
                   "MASTER_ADDR": "other", "MASTER_PORT": "1",
                   "MPPI_NUM_PROCESSES": "2", "WORLD_SIZE": "8",
                   "MPPI_PROCESS_ID": "1", "RANK": "7"}) == ("h0:99", 2, 1)
    assert detect({"MPPI_COORDINATOR_ADDRESS": "h0:99"}) == ("h0:99", None,
                                                            None)
    with pytest.raises(ValueError, match="RANK"):
        detect({"RANK": "two"})
    with pytest.raises(ValueError, match="MASTER_PORT"):
        detect({"MASTER_ADDR": "h0"})
    with pytest.raises(ValueError, match="incomplete multihost"):
        detect({"MPPI_COORDINATOR_ADDRESS": "h0:99", "WORLD_SIZE": "4"})


def _clean_env(monkeypatch):
    for k in ("MPPI_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
              "MPPI_NUM_PROCESSES", "WORLD_SIZE", "MPPI_PROCESS_ID", "RANK"):
        monkeypatch.delenv(k, raising=False)


def test_implicit_single_process_is_noop(monkeypatch):
    """No coordinator anywhere: initialize_multihost forms no group."""
    _clean_env(monkeypatch)
    pmesh.initialize_multihost(device="cpu")
    pmesh.initialize_multihost(device="cpu")
    assert not torch.distributed.is_initialized()


def test_explicit_coordinator_incomplete_args_raise(monkeypatch):
    """A coordinator without a process count is a launch that cannot
    form: it raises, and leaves no group behind."""
    _clean_env(monkeypatch)
    with pytest.raises(ValueError, match="number of processes"):
        pmesh.initialize_multihost("127.0.0.1:9", device="cpu")
    assert not torch.distributed.is_initialized()


def test_dead_coordinator_fails_loudly():
    """A coordinator address nobody serves must raise within the timeout,
    never leave the process running alone."""
    code = (
        "import socket\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "from mppi_robotarm_tpu_torch.parallel.mesh import "
        "initialize_multihost\n"
        "try:\n"
        "    initialize_multihost(f'127.0.0.1:{port}', 2, 1,\n"
        "                         initialization_timeout=3, device='cpu')\n"
        "except (RuntimeError, ValueError):\n"
        "    print('RAISED-AS-REQUIRED')\n"
        "else:\n"
        "    print('SILENT-DEGRADE')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "RAISED-AS-REQUIRED" in out.stdout, (out.stdout, out.stderr)


def test_backend_follows_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert pmesh.backend_for("cpu", 1) == "gloo"
    assert pmesh.backend_for("cuda", 1) == "nccl"
    assert pmesh.backend_for("cuda", 2) == "gloo"     # two ranks, one card


@pytest.fixture
def one_process_group():
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_make_mesh_errors_and_a_mesh_of_one(one_process_group):
    with pytest.raises(ValueError, match="not divisible by samples=2"):
        pmesh.make_mesh(samples=2, device_type="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        pmesh.make_mesh(data=2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
    m = pmesh.make_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("data", "samples")
    assert [pmesh.axis_size(m, a) for a in m.mesh_dim_names] == [1, 1]
    x = torch.arange(6)
    assert torch.equal(psh.scenario_shard(m, x), x)


def test_a_mesh_never_hides_a_requested_fleet(monkeypatch,
                                              one_process_group):
    """A coordinator and a world of 2 in the environment: make_mesh forms
    no group of one in its place, and initialize_multihost after a mesh of
    one raises instead of leaving the process alone."""
    _clean_env(monkeypatch)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "9",
           "WORLD_SIZE": "2", "RANK": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="call initialize_multihost"):
        pmesh.make_mesh(device_type="cpu")
    assert not torch.distributed.is_initialized()
    _clean_env(monkeypatch)
    pmesh.make_mesh(device_type="cpu")          # a group of one
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="2 processes .rank 0. at "
                                           "127.0.0.1:9 were asked for"):
        pmesh.initialize_multihost(device="cpu")
    # the group there is the group asked for: nothing to do
    pmesh.initialize_multihost(num_processes=1, process_id=0, device="cpu")
    assert torch.distributed.get_world_size() == 1


def test_scenario_shard_takes_the_rank_block():
    m = FakeMesh((4, 2), (2, 1))
    st = P.init_sim_batch(P.MPPIConfig(), PSIM, np.arange(8), device="cpu")
    block = psh.scenario_shard(m, st)
    assert torch.equal(block.seed, torch.tensor([4, 5]))
    assert block.mppi.u_prev.shape == (2, 30, 2)
    with pytest.raises(ValueError, match="not divisible by the 'data'"):
        psh.scenario_shard(m, torch.zeros(6))


def test_non_divisible_k_raises():
    m = FakeMesh((1, 8), (0, 0))
    bad = dataclasses.replace(P.MPPIConfig(), num_samples=100)
    with pytest.raises(ValueError, match="not divisible"):
        psh.make_sharded_solve(PARM, bad, m, reduce=lambda x, op: x)
    with pytest.raises(ValueError, match="not divisible"):
        psh.make_sharded_sim_step(PARM, bad, PSIM, m, reduce=lambda x, op: x)
    with pytest.raises(ValueError, match="unknown backend"):
        psh.make_sharded_solve(PARM, P.MPPIConfig(), FakeMesh((1, 1), (0, 0)),
                               backend="xla", reduce=lambda x, op: x)


def test_combine_partials_equals_one_softmax():
    """The two-level combine of shard partials (m_s, η_s, A_s) over a
    stacked leading shard axis equals the softmax over all samples."""
    rng = np.random.default_rng(3)
    s = torch.as_tensor(rng.uniform(0, 50, size=(3, 40)))
    eps = torch.as_tensor(rng.normal(size=(3, 40, 4, 2)))
    lam = 7.0
    cuts = (slice(0, 13), slice(13, 40))
    m_s = torch.stack([torch.amin(s[:, k], 1) for k in cuts])
    e = [torch.exp(-(s[:, k] - m_s[i][:, None]) / lam)
         for i, k in enumerate(cuts)]
    eta_s = torch.stack([v.sum(1) for v in e])
    a_s = torch.stack([torch.einsum("bk,bktu->btu", v, eps[:, k])
                       for v, k in zip(e, cuts)])
    stacked = lambda x, op: (x.amin(0, keepdim=True) if op == "min"
                             else x.sum(0, keepdim=True)).expand_as(x)
    m, eta, a = psh.combine_partials(m_s, eta_s, a_s, lam, stacked)
    w = mppi_weights(s, lam)
    np.testing.assert_allclose(m[0].numpy(), s.amin(1).numpy())
    np.testing.assert_allclose((a[0] / eta[0][:, None, None]).numpy(),
                               torch.einsum("bk,bktu->btu", w, eps).numpy(),
                               rtol=1e-12, atol=1e-14)


def test_local_exp_terms_matches_jax():
    from mppi_robotarm_tpu.ops.weights import local_exp_terms as jlet
    from mppi_robotarm_tpu_torch.ops.weights import local_exp_terms

    s = np.random.default_rng(1).uniform(0, 30, size=(2, 16))
    rho = s.min(-1, keepdims=True)
    e, eta = local_exp_terms(t(s), t(rho), 3.0)
    je, jeta = jlet(jnp.asarray(s), jnp.asarray(rho), 3.0)
    np.testing.assert_allclose(n(e), np.asarray(je), rtol=1e-14)
    np.testing.assert_allclose(n(eta), np.asarray(jeta), rtol=1e-14)


# ---- one process against JAX ------------------------------------------------

def _solve_inputs(cfg, batch, seed, dtype):
    rng = np.random.default_rng(seed)
    obs = np.tile(X0, (batch, 1)) + rng.normal(scale=0.01, size=(batch, 4))
    u_prev = np.tile(np.asarray(cfg.warm_start), (batch, cfg.horizon, 1))
    wp = np.zeros(batch, np.int64)
    eps = rng.normal(size=(batch, cfg.num_samples, cfg.horizon, 2)) \
        * np.sqrt(20.0)
    return [np.asarray(v, dtype) if v.dtype.kind == "f" else v
            for v in (obs, u_prev, wp, eps)]


def _port_solve(shape, cfg, backend, ref, obs, u_prev, wp, eps, dtype):
    def body(m, reduce):
        d, s = m.coord
        f = psh.make_sharded_solve(PARM, cfg, m, backend=backend,
                                   reduce=reduce)
        return f(t(ref, dtype), t(blocks(obs, shape, d), dtype),
                 t(blocks(u_prev, shape, d), dtype),
                 torch.as_tensor(blocks(wp, shape, d)),
                 t(blocks(eps, shape, d, s), dtype))
    return run_mesh(shape, body)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2)])
def test_sharded_solve_eager_matches_jax_xla(ref_path, shape):
    cj, cp = configs(16 * shape[1], 8, exploration=0.25)
    B = 2 * shape[0]
    obs, u_prev, wp, eps = _solve_inputs(cp, B, sum(shape), np.float64)
    jout = jsh.make_sharded_solve(J.ArmParams(), cj,
                                  jmake_mesh(*shape, devices=jax.devices()[
                                      :shape[0] * shape[1]]))(
        jnp.asarray(ref_path), jnp.asarray(obs), jnp.asarray(u_prev),
        jnp.asarray(wp, jnp.int32), jnp.asarray(eps))
    out = _port_solve(shape, cp, "eager", ref_path, obs, u_prev, wp, eps, F64)
    for i, name in enumerate(("u0", "u_seq", "u_next", "wp", "path_end",
                              "S", "w")):
        got = gather(out, shape, i, sample_axis=name in ("S", "w"))
        np.testing.assert_allclose(got, np.asarray(jout[i]), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_solve_cuda_twin_matches_jax_pallas(ref_path, shape):
    """The cuda backend on CPU tensors (``solve_batched_reference`` with
    k_offset and normalize=False, then the two-level combine) against the
    JAX kernel per shard in interpret mode, float32."""
    cj, cp = configs(128 * shape[1], 6)
    B = shape[0]
    obs, u_prev, wp, eps = _solve_inputs(cp, B, 7, np.float32)
    ref = np.asarray(ref_path, np.float32)
    jout = jsh.make_sharded_solve(
        J.ArmParams(), cj, jmake_mesh(*shape, devices=jax.devices()[
            :shape[0] * shape[1]]), backend="pallas", interpret=True)(
        jnp.asarray(ref), jnp.asarray(obs), jnp.asarray(u_prev),
        jnp.asarray(wp, jnp.int32), jnp.asarray(eps))
    out = _port_solve(shape, cp, "cuda", ref, obs, u_prev, wp, eps, F32)
    np.testing.assert_allclose(gather(out, shape, 5, True),
                               np.asarray(jout[5]), rtol=2e-5)
    for i in (0, 1, 2):
        np.testing.assert_allclose(gather(out, shape, i, False),
                                   np.asarray(jout[i]), atol=U_TOL)
    np.testing.assert_allclose(gather(out, shape, 6, True),
                               np.asarray(jout[6]), rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(gather(out, shape, 3, False),
                                  np.asarray(jout[3]))


def _folded_threefry(keys, shape, cfg, dtype):
    """JAX's per-shard draws of ``make_sharded_sim_step``: scenario b,
    shard s samples ``sample_epsilon(fold_in(key_b, s), K / S, T)``;
    returns (B, S, K / S, T, 2)."""
    S = shape[1]
    chol = sigma_cholesky(cfg.sigma)
    return np.stack([np.stack([np.asarray(sample_epsilon(
        jax.random.fold_in(jax.random.wrap_key_data(jnp.asarray(k)), s),
        cfg.num_samples // S, cfg.horizon, chol, dtype))
        for s in range(S)]) for k in keys])


@pytest.mark.parametrize("backend,dtype", [("eager", np.float64),
                                           ("cuda", np.float32)])
def test_sharded_sim_step_matches_jax(ref_path, backend, dtype):
    """Three closed-loop steps on a (2, 2) mesh with JAX's folded threefry
    draws injected: eager against xla to 1e-12·4^i in float64, cuda (the
    twin) against pallas in interpret mode in phase 2's bands."""
    shape, B, steps = (2, 2), 4, 3
    cj, cp = configs(32, 6)
    mesh = jmake_mesh(*shape, devices=jax.devices()[:4])
    jstep = jsh.make_sharded_sim_step(
        J.ArmParams(), cj, J.SimConfig(), mesh,
        **({} if backend == "eager" else dict(
            backend="pallas", noise="threefry", interpret=True)))
    ref = np.asarray(ref_path, dtype)
    q = np.tile(X0[:2], (B, 1)).astype(dtype)
    st_j = (jnp.asarray(q), jnp.zeros((B, 2), dtype),
            jnp.tile(jnp.asarray(cj.warm_start, dtype), (B, 6, 1)),
            jnp.zeros(B, jnp.int32))
    st_p = [st_j[0], st_j[1], st_j[2], np.zeros(B, np.int64)]
    qt, ut = (1e-12, 1e-12) if backend == "eager" else (Q_TOL, U_TOL)
    tdt = torch.float64 if dtype == np.float64 else F32
    key = jax.random.PRNGKey(3)
    for i in range(steps):
        key, sub = jax.random.split(key)
        keys = np.asarray(jax.random.key_data(jax.vmap(
            lambda s: jax.random.fold_in(sub, s))(jnp.arange(B))),
            np.uint32)
        eps = _folded_threefry(keys, shape, cj, dtype)
        jo = jstep(jnp.asarray(ref), *st_j, jnp.asarray(keys))

        def body(m, reduce):
            d, s = m.coord
            f = psh.make_sharded_sim_step(PARM, cp, PSIM, m, backend=backend,
                                          noise="eps", reduce=reduce)
            blk = lambda x: blocks(np.asarray(x), shape, d)
            return f(t(ref, tdt), t(blk(st_p[0]), tdt), t(blk(st_p[1]), tdt),
                     t(blk(st_p[2]), tdt), torch.as_tensor(blk(st_p[3])),
                     eps=t(blocks(eps, shape, d)[:, s], tdt))

        out = run_mesh(shape, body)
        po = [gather(out, shape, j, False) for j in range(6)]
        np.testing.assert_allclose(po[0], np.asarray(jo[0]),
                                   atol=qt * 4 ** i, err_msg=f"q step {i}")
        np.testing.assert_allclose(po[5], np.asarray(jo[5]),
                                   atol=ut * 4 ** i, err_msg=f"u0 step {i}")
        np.testing.assert_array_equal(po[3], np.asarray(jo[3]))
        np.testing.assert_array_equal(po[4], np.asarray(jo[4]))
        st_j = jo[:4]
        st_p = po[:4]


@pytest.mark.parametrize("chained", [False, True])
def test_sharded_fleet_matches_jax(ref_path, monkeypatch, chained):
    """Each data rank's fleet (the stacked plain twin at K=128) against
    JAX's ``make_sharded_fleet`` in interpret mode on a (2, 1) mesh, in
    phase 2's bands; chained launches (a small launch budget) equal one
    launch bit for bit."""
    shape, B, steps = (2, 1), 4, 4
    cj, cp = configs(128, 6)
    ref = np.asarray(ref_path[:400], np.float32)
    rng = np.random.default_rng(7)
    q0 = (np.tile(X0[:2], (B, 1))
          + rng.normal(scale=0.01, size=(B, 2))).astype(np.float32)
    eps = eps_noise(11, (B, steps, 128, 6, 2))
    rec_j, ufin_j = jsh.make_sharded_fleet(
        J.ArmParams(), cj, J.SimConfig(), jmake_mesh(
            *shape, devices=jax.devices()[:2]), steps, interpret=True)(
        jnp.asarray(ref), jnp.asarray(q0), jnp.zeros((B, 2), jnp.float32),
        jnp.tile(jnp.asarray(cj.warm_start, jnp.float32), (B, 6, 1)),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jnp.zeros(B, jnp.int32), eps=jnp.asarray(eps))
    rec_j = np.asarray(rec_j)

    def run(budget):
        if budget:
            monkeypatch.setattr(ploop, "_FUSED_MAX_STEPS", budget)
        states = P.init_sim_batch(cp, PSIM, np.arange(B), q0=q0,
                                  device="cpu")
        return [psh.make_sharded_fleet(PARM, cp, PSIM, FakeMesh(shape, (d, 0)),
                                       steps)(
            t(ref, F32), psh.scenario_shard(FakeMesh(shape, (d, 0)), states),
            t(blocks(eps, shape, d), F32)) for d in range(shape[0])]

    outs = run(3 if chained else None)      # 2 scenarios: 1 step a launch
    rec = lambda f: np.concatenate([getattr(r, f).numpy().swapaxes(0, 1)
                                    for _, r in outs])
    for i in range(steps):
        np.testing.assert_allclose(rec("q")[:, i], rec_j[:, i, 0:2],
                                   atol=Q_TOL * 4 ** i)
        np.testing.assert_allclose(rec("u")[:, i], rec_j[:, i, 4:6],
                                   atol=U_TOL * 4 ** i)
    np.testing.assert_array_equal(rec("wp_idx"), rec_j[..., 6])
    np.testing.assert_array_equal(rec("done"), rec_j[..., 7] > 0.5)
    np.testing.assert_allclose(
        np.concatenate([f.mppi.u_prev.numpy() for f, _ in outs]),
        np.asarray(ufin_j), atol=U_TOL * 4 ** steps)
    if chained:
        monkeypatch.undo()
        one = run(None)
        for (fa, ra), (fb, rb) in zip(outs, one):
            for a, b in zip(ra, rb):
                assert torch.equal(a, b)
            assert torch.equal(fa.mppi.u_prev, fb.mppi.u_prev)


def test_elide_collectives_twin(ref_path):
    """``elide_collectives`` builds the same program without the
    exchanges: the same bits on a 1-wide samples axis, other results once
    the axis is real (as JAX's twin, tests/test_sharding.py); lam = 3e5
    gives tens of samples weight, so each shard's own softmax differs from
    the global one."""
    _, cp = configs(64, 6, lam=3e5)
    obs, u_prev, wp, eps = _solve_inputs(cp, 1, 5, np.float32)
    ref = np.asarray(ref_path, np.float32)
    m1 = FakeMesh((1, 1), (0, 0))
    a = psh.make_sharded_solve(PARM, cp, m1, backend="cuda",
                               reduce=lambda x, op: x)
    args = (t(ref, F32), t(obs, F32), t(u_prev, F32), torch.as_tensor(wp),
            t(eps, F32))
    x = a(*args)
    elided = psh.SamplesAllReduce(None, elide=True)
    y = psh.make_sharded_solve(PARM, cp, m1, backend="cuda",
                               reduce=elided)(*args)
    assert elided.calls == 2
    for u, v in zip(x, y):
        assert torch.equal(u, v)
    shape = (1, 2)
    full = _port_solve(shape, cp, "cuda", ref, obs, u_prev, wp, eps, F32)
    lone = run_mesh(shape, lambda m, r: psh.make_sharded_solve(
        PARM, cp, m, backend="cuda", reduce=psh.SamplesAllReduce(
            m, elide=True))(*args[:4], t(blocks(eps, shape, 0,
                                                m.coord[1]), F32)))
    for s in range(2):
        assert not np.allclose(full[0][s][1].numpy(), lone[0][s][1].numpy())


# ---- real processes ------------------------------------------------------------

def _dryrun(tmp, world, data, samples):
    out = os.path.join(tmp, f"w{world}")
    r = subprocess.run(
        [sys.executable, "-m", "mppi_robotarm_tpu_torch.parallel.dryrun",
         "--world", str(world), "--data", str(data), "--samples",
         str(samples), "--device", "cpu", "--out", out],
        cwd=REPO, capture_output=True, text=True,
        timeout=dryrun.TIMEOUT_S + 60)
    assert r.returncode == 0, r.stdout + r.stderr
    return [dict(np.load(os.path.join(out, f"rank{k}.npz")))
            for k in range(world)], out


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """The 2-rank (1, 2) and 4-rank (2, 2) gloo runs, once per module."""
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    return {(1, 2): _dryrun(tmp, 2, 1, 2), (2, 2): _dryrun(tmp, 4, 2, 2)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_dryrun_ranks_equal_one_process(dryruns, shape):
    """Every rank's blocks equal the one-process results bit for bit: the
    sharded steps run here on the thread mesh, the fleet unsharded."""
    ranks, out = dryruns[shape]
    arm, sim, (cfg, path, B, steps), (fcfg, fpath, fB, fsteps) = \
        dryrun.problem("tiny", *shape)
    ref = torch.as_tensor(path)
    full = P.init_sim_batch(cfg, sim, np.arange(B), device="cpu")
    for prog in ("step-eager", "step-cuda"):
        res = run_mesh(shape, lambda m, red: dryrun.step_program(
            arm, cfg, sim, m, prog.split("-")[1], ref,
            psh.scenario_shard(m, full), steps, reduce=red))
        for k, z in enumerate(ranks):
            d, s = int(z["data_rank"]), int(z["samples_rank"])
            assert (d, s) == (k // shape[1], k % shape[1])
            for f in ("q", "u0", "wp_idx", "done", "final_dq",
                      "final_u_prev", "final_step"):
                np.testing.assert_array_equal(z[f"{prog}_{f}"],
                                              res[d][s][f].numpy(),
                                              err_msg=f"{prog} {f} rank {k}")
            assert z[f"{prog}_collectives_per_solve"] == (
                3 if prog == "step-eager" else 2)
            # the plain twin on CPU tensors launches no kernel
            assert int(z[f"{prog}_solve_launches"]) == 0
    states = P.init_sim_batch(fcfg, sim, np.arange(fB),
                              q0=dryrun.fleet_q0("tiny", fB, sim),
                              device="cpu")
    final, rec = P.simulate_fused_batch(arm, fcfg, sim, torch.as_tensor(fpath),
                                        states, fsteps)
    b = fB // shape[0]
    for z in ranks:
        d = int(z["data_rank"])
        rows = slice(d * b, (d + 1) * b)
        for f in dryrun.FLEET_FIELDS:
            np.testing.assert_array_equal(z[f"fleet_{f}"],
                                          getattr(rec, f)[:, rows].numpy())
        np.testing.assert_array_equal(z["fleet_u_final"],
                                      final.mppi.u_prev[rows].numpy())
        assert bool(z["fleet_checkpoint_bitwise"])
    assert os.path.isdir(os.path.join(out, "fleet_checkpoint"))


def test_dryrun_ranks_leave_jax_out(dryruns):
    """The ranks, started in new interpreters, never import JAX."""
    for ranks, _ in dryruns.values():
        assert not any(bool(z["jax_imported"]) for z in ranks)


def test_new_modules_never_import_jax():
    code = ("import sys\n"
            "import mppi_robotarm_tpu_torch.parallel.dryrun\n"
            "import mppi_robotarm_tpu_torch.parallel.sharded\n"
            "import mppi_robotarm_tpu_torch.utils.debug\n"
            "import mppi_robotarm_tpu_torch.sim.pathgen\n"
            "import mppi_robotarm_tpu_torch.compat\n"
            "import mppi_robotarm_tpu_torch.examples.sharded_fleet\n"
            "import mppi_robotarm_tpu_torch.examples.reference_drop_in\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m.startswith('mppi_robotarm_tpu.') or "
            "m == 'mppi_robotarm_tpu' for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_dist_checkpoint_world_of_one(tmp_path):
    """Without a process group the checkpoint is a one-process save, and
    a restore gives the state back bit for bit (batched and single)."""
    from mppi_robotarm_tpu_torch.utils.checkpoint import (
        load_checkpoint_dist, save_checkpoint_dist)

    cfg = P.MPPIConfig()
    st = P.init_sim_batch(cfg, PSIM, [3, 4, 5], device="cpu")
    st, _ = P.simulate_fused_batch(PARM, dataclasses.replace(
        cfg, num_samples=16, horizon=30), PSIM, torch.as_tensor(
            P.synth_circle_path(300)), st, 2)
    save_checkpoint_dist(str(tmp_path / "b"), st)
    back = load_checkpoint_dist(str(tmp_path / "b"), device="cpu")
    for a, b in zip(ploop._state_tensors(st), ploop._state_tensors(back)):
        assert torch.equal(a, b)
    one = P.init_sim(cfg, PSIM, seed=9, device="cpu")
    save_checkpoint_dist(str(tmp_path / "s"), one)
    back = load_checkpoint_dist(str(tmp_path / "s"), device="cpu")
    assert back.seed == 9 and torch.equal(back.q, one.q)
    with pytest.raises(ValueError, match="data1"):
        load_checkpoint_dist(str(tmp_path / "s"), FakeMesh((2, 1), (1, 0)),
                             device="cpu")


def _save_as_ranks(path, st, shape):
    """What a collective save of ``st`` by the ranks of a (shape[0] x 1)
    mesh writes, each its block: their state dicts, merged, in one
    one-process save (the ranks' replicated ``data_size`` once)."""
    import torch.distributed.checkpoint as dcp

    from mppi_robotarm_tpu_torch.parallel.sharded import scenario_shard
    from mppi_robotarm_tpu_torch.utils import checkpoint

    sd = {}
    for d in range(shape[0]):
        mesh = FakeMesh(shape, (d, 0))
        sd.update(checkpoint._dist_state_dict(scenario_shard(mesh, st),
                                              mesh))
    dcp.save(sd, checkpoint_id=path, no_dist=True)


@pytest.mark.parametrize("restore", [None, (1, 1), (4, 1), (2, 1)])
def test_dist_checkpoint_restores_the_whole_fleet_on_any_data_size(
        tmp_path, restore):
    """A (2 x 1) save of a 4-scenario fleet, restored with ``mesh=None``
    or on a (1 x 1) mesh, gives the whole fleet; on a (4 x 1) mesh each
    rank its one scenario; on the save's own (2 x 1) each rank its block:
    never part of the fleet in silence."""
    from mppi_robotarm_tpu_torch.utils.checkpoint import load_checkpoint_dist

    cfg = P.MPPIConfig()
    st = P.init_sim_batch(cfg, PSIM, [3, 4, 5, 6], device="cpu")
    st, _ = P.simulate_fused_batch(PARM, dataclasses.replace(
        cfg, num_samples=16, horizon=30), PSIM, torch.as_tensor(
            P.synth_circle_path(300)), st, 2)
    path = str(tmp_path / "ck")
    _save_as_ranks(path, st, (2, 1))
    ranks = [None] if restore is None else [
        FakeMesh(restore, (d, 0)) for d in range(restore[0])]
    backs = [load_checkpoint_dist(path, mesh, device="cpu")
             for mesh in ranks]
    whole = [torch.cat(v) for v in zip(*(ploop._state_tensors(b)
                                         for b in backs))]
    for a, b in zip(ploop._state_tensors(st), whole):
        assert torch.equal(a, b)
    assert all(b.q.shape[0] == 4 // len(ranks) for b in backs)


def test_dist_checkpoint_refuses_a_cut_it_cannot_make(tmp_path):
    """A fleet the new 'data' size does not divide, and a single scenario
    on a mesh of several blocks, raise."""
    from mppi_robotarm_tpu_torch.utils.checkpoint import (
        load_checkpoint_dist, save_checkpoint_dist)

    st = P.init_sim_batch(P.MPPIConfig(), PSIM, [3, 4, 5, 6], device="cpu")
    _save_as_ranks(str(tmp_path / "b"), st, (2, 1))
    with pytest.raises(ValueError, match="not divisible"):
        load_checkpoint_dist(str(tmp_path / "b"), FakeMesh((3, 1), (0, 0)),
                             device="cpu")
    save_checkpoint_dist(str(tmp_path / "s"), P.init_sim(
        P.MPPIConfig(), PSIM, seed=2, device="cpu"))
    with pytest.raises(ValueError, match="one scenario"):
        load_checkpoint_dist(str(tmp_path / "s"), FakeMesh((2, 1), (0, 0)),
                             device="cpu")


def test_build_lock_compiles_once(tmp_path, monkeypatch):
    """Two builds at once (two ranks reaching their first launch) compile
    the library once: the second waits on the lock, then finds it
    current."""
    import time as _time

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    compiles = []

    def fake_run_all(cmds):
        compiles.append(len(cmds))
        _time.sleep(0.3)
        for c in cmds:
            with open(c[c.index("-o") + 1], "w") as f:
                f.write("x")
        return ""

    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    errors = []

    def build():
        try:
            _build.build()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert not errors, errors
    n_src = len(list(_build._CSRC.glob("*.cu")))
    assert compiles == [n_src, 1]            # one compile pass, one link
    assert (tmp_path / _build.LIB_NAME).exists()
    assert _build.build() == ""


# ---- on the card (chip_smoke phases 16-17) ----------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the solve kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_kernel_shards_combine_to_one_solve(dev, S, noise):
    """K=1024 split into S launches of the solve kernel with k_offset and
    normalize=False, combined by ``combine_partials``, against one
    unsharded launch: S and m bitwise, Σwε within 2e-5, η within 2e-5
    relative."""
    arm, cfg, _ = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, lam=3e5)
    B, K, T = 8, cfg.num_samples, cfg.horizon
    rng = np.random.default_rng(S)
    x0 = torch.as_tensor(np.tile(X0, (B, 1)).astype(np.float32) + 0.01,
                         device=dev)
    u = torch.as_tensor((np.array([10.0, -2.0]) + rng.normal(
        size=(B, T, 2))).astype(np.float32), device=dev)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    win = ref[:cfg.search_idx_len][None].repeat(B, 1, 1).contiguous()
    kw = {}
    if noise == "eps":
        eps = torch.as_tensor((rng.normal(size=(B, K, T, 2)) * np.sqrt(
            20.0)).astype(np.float32), device=dev)
    else:
        kw = dict(seed=torch.arange(B, device=dev) + 3,
                  step=torch.full((B,), 11, device=dev))
    w1, s1, _, (m1, eta1) = cuda_solve.solve_batched(
        arm, cfg, x0, u, win, emit_eps=False,
        **(dict(eps=eps) if noise == "eps" else kw))
    kl = K // S
    parts = [cuda_solve.solve_batched(
        arm, cfg, x0, u, win, emit_eps=False, normalize=False, k_local=kl,
        k_offset=torch.full((B,), r * kl, device=dev),
        **(dict(eps=eps[:, r * kl:(r + 1) * kl].contiguous())
           if noise == "eps" else kw)) for r in range(S)]
    stacked = lambda x, op: (x.amin(0, keepdim=True) if op == "min"
                             else x.sum(0, keepdim=True)).expand_as(x)
    m, eta, a = psh.combine_partials(
        torch.stack([p[3][0] for p in parts]),
        torch.stack([p[3][1] for p in parts]),
        torch.stack([p[0] for p in parts]), cfg.lam, stacked)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), s1)
    assert torch.equal(m[0], m1)
    assert float((a[0] / eta[0][:, None, None] - w1).abs().max()) <= 2e-5
    assert float(((eta[0] - eta1).abs() / eta1).max()) <= 2e-5


@pytest.mark.cuda
def test_dryrun_on_the_card(dev, tmp_path):
    """Two ranks on cuda:0 over gloo: a (1, 2) and a (2, 1) mesh of the
    tiny problem, every program, finite, no JAX."""
    for data, samples in ((1, 2), (2, 1)):
        out = str(tmp_path / f"{data}x{samples}")
        r = subprocess.run(
            [sys.executable, "-m", "mppi_robotarm_tpu_torch.parallel.dryrun",
             "--world", "2", "--data", str(data), "--samples", str(samples),
             "--device", "cuda", "--out", out],
            cwd=REPO, capture_output=True, text=True,
            timeout=dryrun.TIMEOUT_S + 60)
        assert r.returncode == 0, r.stdout + r.stderr
        for k in range(2):
            z = np.load(os.path.join(out, f"rank{k}.npz"))
            assert not bool(z["jax_imported"])
            assert bool(z["fleet_checkpoint_bitwise"])
            # one solve kernel launch a step on the cuda backend, none eager
            steps = dryrun.problem("tiny", data, samples)[2][3]
            assert int(z["step-cuda_solve_launches"]) == steps
            assert int(z["step-eager_solve_launches"]) == 0
            for f in z.files:
                if z[f].dtype.kind == "f":
                    assert np.isfinite(z[f]).all(), f
