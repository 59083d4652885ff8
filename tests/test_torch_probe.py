"""The launch-overhead probes and the chains of ``tools/overhead.py``.

On the CPU: the probes' plain versions (``ops/cuda_probe.py``) against
``tools/tpu_overhead.py``'s two Pallas kernels, restated here because that
script imports JAX at top level and cannot be imported, run in interpret
mode on the same seeded (8, 128) float32 input, bit for bit; the two solve
chains, 3 iterations at K=256, H=10 on injected NumPy noise, through the
port's ``run_chain`` over ``solve_core`` against the same chain through
JAX's ``pallas_solve_core(interpret=True)``, with the tolerances of
``test_torch_solve_kernel.py::test_twin_matches_jax_kernel`` (lam = 3e5;
S rtol 2e-5, Σwε and the carried u atol 2e-5); the wrappers' checks.

Marked ``cuda`` and skipped without a card: the kernels against their plain
versions (P2, one block an SM, also at sizes its blocks do not divide),
each graph chain against its eager chain bit for bit, and a captured
``solve_batched`` against an uncaptured one.  JAX is imported only
inside the CPU tests, so on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_probe.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_probe, cuda_solve
from mppi_robotarm_tpu_torch.tools import overhead

torch.set_num_threads(1)
LAM = 3e5
RTOL_S = 2e-5
ATOL_W = 2e-5
CHAIN_ITERS = 3


def _probe_input(seed=0, shape=(8, 128)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pallas_probes():
    """tools/tpu_overhead.py:45-74, in interpret mode: (triv, big)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)

    def triv_kernel(i_ref, o_ref):
        o_ref[...] = i_ref[...] * 1.000001

    def triv(c):
        return pl.pallas_call(
            triv_kernel, in_specs=[vmem], out_specs=vmem,
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)(c)

    def big_kernel(i_ref, o_ref, big_ref, scratch):
        scratch[...] = jnp.zeros_like(scratch)
        big_ref[...] = scratch[...]
        o_ref[...] = i_ref[...] * 1.000001

    def big(c):
        return pl.pallas_call(
            big_kernel, in_specs=[vmem], out_specs=[vmem, vmem],
            out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32),
                       jax.ShapeDtypeStruct((100, 8, 128), jnp.float32)],
            scratch_shapes=[pltpu.VMEM((100, 8, 128), jnp.float32)],
            interpret=True)(c)

    return triv, big


def test_probe_plain_versions_match_pallas_kernels():
    import jax.numpy as jnp

    triv, big = _pallas_probes()
    x = _probe_input()
    o_j = np.asarray(triv(jnp.asarray(x)))
    assert o_j.dtype == np.float32
    np.testing.assert_array_equal(
        cuda_probe.probe_scale(torch.as_tensor(x)).numpy(), o_j)
    ob_j, b_j = (np.asarray(v) for v in big(jnp.asarray(x)))
    o_p, b_p = cuda_probe.probe_big(torch.as_tensor(x))
    np.testing.assert_array_equal(o_p.numpy(), ob_j)
    np.testing.assert_array_equal(o_p.numpy(), o_j)
    np.testing.assert_array_equal(b_p.numpy(), b_j)
    assert b_p.dtype == torch.float32 and not b_p.any()


@pytest.mark.parametrize("emit_eps", [True, False])
def test_solve_chain_matches_jax(ref_path, monkeypatch, emit_eps):
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    from mppi_robotarm_tpu.ops.pallas_rollout import pallas_solve_core
    from mppi_robotarm_tpu.ops.waypoint import slice_window
    from _torch_port_helpers import configs, eps_noise

    K, T = 256, 10
    cj, cp = configs(K, T, lam=LAM)
    x0 = np.asarray(overhead.X0, np.float32)
    u0 = np.tile(np.asarray(cj.warm_start, np.float32), (T, 1))
    win = np.array(slice_window(jnp.asarray(ref_path, jnp.float32), 0,
                                cj.search_idx_len)[0])
    eps = eps_noise(K + T, (CHAIN_ITERS, K, T, 2))

    u, got_j = jnp.asarray(u0), []
    for i in range(CHAIN_ITERS):
        w, s, _ = pallas_solve_core(
            J.ArmParams(), cj, jnp.asarray(x0), u, jnp.asarray(win),
            jnp.asarray(float(cj.search_idx_len)), eps=jnp.asarray(eps[i]),
            interpret=True, tile=128, emit_eps=emit_eps)
        got_j.append((np.asarray(w), np.asarray(s)))
        u = u + 1e-6 * w

    got_p, solve_core = [], cuda_solve.solve_core

    def spy(*a, **k):
        out = solve_core(*a, **k)
        got_p.append(out)
        return out

    monkeypatch.setattr(cuda_solve, "solve_core", spy)
    step = overhead.solve_step(P.ArmParams(), cp, torch.as_tensor(x0),
                               torch.as_tensor(win), emit_eps=emit_eps,
                               eps=torch.as_tensor(eps))
    u_p, n_p = overhead.run_chain(
        step, (torch.as_tensor(u0), torch.tensor(0)), CHAIN_ITERS)
    assert int(n_p) == CHAIN_ITERS and len(got_p) == CHAIN_ITERS
    for (w_j, s_j), (w_p, s_p, e_p) in zip(got_j, got_p):
        np.testing.assert_allclose(s_p.numpy(), s_j, rtol=RTOL_S)
        np.testing.assert_allclose(w_p.numpy(), w_j, rtol=0, atol=ATOL_W)
        assert (e_p is None) == (not emit_eps)
    np.testing.assert_allclose(u_p.numpy(), np.asarray(u), rtol=0,
                               atol=ATOL_W)


def test_cpu_launches_nothing_and_validates():
    before = (cuda_probe.SCALE_LAUNCHES, cuda_probe.BIG_LAUNCHES)
    x = torch.as_tensor(_probe_input(1, (3, 5, 7)))
    assert torch.equal(cuda_probe.probe_scale(x), x * cuda_probe.SCALE)
    o, b = cuda_probe.probe_big(x)
    assert torch.equal(o, x * cuda_probe.SCALE)
    assert b.shape == cuda_probe.BIG_SHAPE
    assert (cuda_probe.SCALE_LAUNCHES, cuda_probe.BIG_LAUNCHES) == before
    for probe in (cuda_probe.probe_scale, cuda_probe.probe_big):
        with pytest.raises(TypeError):
            probe(x.double())
        with pytest.raises(TypeError):
            probe(_probe_input())
        with pytest.raises(ValueError, match="elements"):
            probe(torch.zeros((0, 128)))
        with pytest.raises(ValueError, match="contiguous"):
            probe(x.transpose(0, 2))


def test_probe_big_takes_whole_16_byte_units_of_zeros():
    """P2's zeros may take any shape of a multiple of 4 floats (the
    kernel stores 16-byte units); the plain version makes that shape."""
    x = torch.as_tensor(_probe_input(3))
    for shape in ((97, 132), (4,), (2, 50, 4)):
        o, b = cuda_probe.probe_big(x, big_shape=shape)
        assert b.shape == shape and not b.any()
        assert torch.equal(o, x * cuda_probe.SCALE)
    for bad in ((3,), (5, 7), (0, 4)):
        with pytest.raises(ValueError, match="multiple of 4"):
            cuda_probe.probe_big(x, big_shape=bad)


def test_chains_run_on_the_cpu_and_time_chain_needs_cuda():
    """Each chain's step runs eagerly on CPU tensors through the plain
    versions; timing and the command line need a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    steps = overhead.chains("cpu")
    assert len(steps) == 5
    x = steps[1][2]
    want = x.numpy()
    for _ in range(CHAIN_ITERS):
        want = want * np.float32(cuda_probe.SCALE)
    for name, fn, carry in steps[:3]:
        out = overhead.run_chain(fn, carry, CHAIN_ITERS)
        assert out.shape == (8, 128) and torch.isfinite(out).all(), name
    assert np.array_equal(overhead.run_chain(steps[1][1], x, CHAIN_ITERS)
                          .numpy(), want)
    assert np.array_equal(overhead.run_chain(steps[2][1], x, CHAIN_ITERS)
                          .numpy(), want)
    u, seed = overhead.run_chain(steps[4][1], steps[4][2], 2)
    assert u.shape == (50, 2) and int(seed) == 2
    assert overhead.same_bits((u, seed), (u.clone(), seed.clone()))
    with pytest.raises(RuntimeError, match="CUDA"):
        overhead.time_chain(steps[1][1], x)
    assert overhead.main() != 0


# ---- on the card --------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (1000,), (3, 5, 7)])
def test_probe_kernels_match_plain(dev, shape):
    x = torch.as_tensor(_probe_input(2, shape), device=dev)
    before = (cuda_probe.SCALE_LAUNCHES, cuda_probe.BIG_LAUNCHES)
    o = cuda_probe.probe_scale(x)
    ob, b = cuda_probe.probe_big(x)
    torch.cuda.synchronize()
    assert (cuda_probe.SCALE_LAUNCHES, cuda_probe.BIG_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(o, cuda_probe.probe_scale_reference(x))
    assert torch.equal(ob, o)
    assert b.shape == cuda_probe.BIG_SHAPE and not bool(b.any())


@pytest.mark.cuda
@pytest.mark.parametrize("big_shape", [
    (100, 8, 128),     # the probe: 25,600 16-byte stores
    (97, 132),         # 3,201 stores: the blocks' threads do not divide it
    (4,),              # one store
    (1000, 1000)])     # 4 MB: several passes a thread
def test_probe_big_matches_plain_at_any_size(dev, big_shape):
    x = torch.as_tensor(_probe_input(4), device=dev)
    big_ref = cuda_probe.probe_big_reference(x, big_shape)[1]
    for _ in range(2):    # the second into memory that held other values
        o, b = cuda_probe.probe_big(x, big_shape=big_shape)
        torch.cuda.synchronize()
        assert torch.equal(o, cuda_probe.probe_scale_reference(x))
        assert torch.equal(b, big_ref)
        torch.full(big_shape, 7.0, device=dev)       # dirty the pool


@pytest.mark.cuda
def test_graph_chains_equal_eager_chains(dev):
    arm, cfg, _ = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=256, horizon=20)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    x0 = torch.tensor(overhead.X0, device=dev)
    u0 = torch.tensor(cfg.warm_start, device=dev).repeat(cfg.horizon, 1)
    seed0 = torch.zeros((), dtype=torch.int64, device=dev)
    win = ref[:cfg.search_idx_len].contiguous()
    steps = overhead.chains(dev)[:3] + [
        ("solve", overhead.solve_step(arm, cfg, x0, win), (u0, seed0)),
        ("solve no eps", overhead.solve_step(arm, cfg, x0, win,
                                             emit_eps=False), (u0, seed0))]
    for name, fn, carry in steps:
        t = overhead.time_chain(fn, carry, n=10, reps=1)
        assert overhead.same_bits(t.eager_carry, t.graph_carry), name
        assert t.eager_us > 0 and t.graph_us > 0 and t.launches >= 1, name


@pytest.mark.cuda
def test_captured_solve_batched_equals_uncaptured(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=300, horizon=12,
                              lam=LAM)
    B = 3
    rng = np.random.default_rng(5)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    x0 = torch.as_tensor((np.asarray(overhead.X0) + rng.normal(
        scale=0.01, size=(B, 4))).astype(np.float32), device=dev)
    u = torch.tensor(cfg.warm_start, device=dev).repeat(B, cfg.horizon, 1)
    win = torch.stack([ref[7 * b:7 * b + cfg.search_idx_len]
                       for b in range(B)])
    seed = torch.tensor([4, 9, 2], device=dev)
    zero = cuda_solve.solve_batched(
        P.ArmParams(), cfg, x0, u, win, seed=seed,
        step=torch.zeros(B, dtype=torch.int64, device=dev), fuse_update=True)
    for step in (torch.tensor([0, 5, 11], device=dev), None):
        call = lambda: cuda_solve.solve_batched(
            P.ArmParams(), cfg, x0, u, win, seed=seed, step=step,
            fuse_update=True)
        want = call()
        graph = torch.cuda.CUDAGraph()
        before = cuda_solve.LAUNCHES
        with torch.cuda.graph(graph):
            got = call()
        assert cuda_solve.LAUNCHES == before + 1
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert cuda_solve.LAUNCHES == before + 1
        for a, b in zip((want[0], want[1], want[2], *want[3]),
                        (got[0], got[1], got[2], *got[3])):
            assert torch.equal(a, b)
    # no step tensor is the kernel's step 0
    for a, b in zip((zero[0], zero[1], zero[2]), (want[0], want[1], want[2])):
        assert torch.equal(a, b)
