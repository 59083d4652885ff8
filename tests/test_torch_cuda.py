"""The CUDA kernels against their plain PyTorch twins, on the card: the
fused closed loop (``sim_kernel``, also at every cluster size against
``cluster=1`` bit for bit), the scenario fleet (``fleet_kernel``, also
against ``sim_kernel`` bit for bit) and the per-step solve
(``solve_kernel`` with its combine pass).  Marked ``cuda``: without an NVIDIA GPU (and nvcc)
every test skips.
The file imports nothing of JAX, so on a GPU machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve
from mppi_robotarm_tpu_torch.ops.cuda_rollout import philox_epsilon

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
ARM, SIM = P.ArmParams(), P.SimConfig()


def eps_noise(seed, shape):
    """N(0, 20·I) float32 noise from a NumPy seed."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * np.sqrt(20.0)).astype(np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _args(cfg, dev, steps, ref_len=400, B=2):
    ref = torch.as_tensor(P.synth_circle_path(2000)[:ref_len], device=dev)
    f32 = torch.float32
    q0 = (torch.tensor([SIM.q0], dtype=f32, device=dev).repeat(B, 1)
          + 0.01 * torch.arange(B, device=dev)[:, None])
    return (ARM, cfg, SIM, ref, q0, torch.zeros(B, 2, device=dev),
            torch.tensor(cfg.warm_start, dtype=f32,
                         device=dev).repeat(B, cfg.horizon, 1).contiguous(),
            torch.tensor([0, 3], device=dev)[:B],
            torch.tensor([5, 9], device=dev)[:B], steps)


@pytest.mark.parametrize("K,H,noise", [(128, 8, "eps"), (100, 6, "eps"),
                                       (1024, 50, "prng"), (40, 50, "prng")])
def test_kernel_matches_twin(dev, K, H, noise):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=H)
    steps = 6
    args = _args(cfg, dev, steps)
    eps = (torch.as_tensor(eps_noise(K, (2, steps, K, H, 2)), device=dev)
           if noise == "eps" else None)
    before = cuda_sim.LAUNCHES
    rec_k, uf_k = cuda_sim.fused_sim_run_batched(*args, eps=eps)
    assert cuda_sim.LAUNCHES == before + 1
    rec_p, uf_p = cuda_sim.fused_sim_reference(*args, eps=eps)
    rk, rp = rec_k.cpu().numpy(), rec_p.cpu().numpy()
    for i in range(steps):
        np.testing.assert_allclose(rk[:, i, 0:2], rp[:, i, 0:2],
                                   atol=2e-6 * 4 ** i)
        np.testing.assert_allclose(rk[:, i, 4:6], rp[:, i, 4:6],
                                   atol=2e-5 * 4 ** i)
    np.testing.assert_array_equal(rk[..., 6:8], rp[..., 6:8])
    np.testing.assert_allclose(rk[:, 0, 8:12], rp[:, 0, 8:12], rtol=1e-4)


@pytest.mark.parametrize("preset,steps", [("benchmark_preset", 30),
                                          ("circle_tracking_preset", 30)])
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_every_cluster_size_equals_cluster_one(dev, preset, steps, noise):
    """Records and u_final at every cluster size that fits K equal one
    block's bit for bit: the warp partials are folded in the same order."""
    arm, cfg, sim = getattr(P, preset)()
    K, T = cfg.num_samples, cfg.horizon
    ref = torch.as_tensor(P.synth_circle_path(8000), device=dev)
    s0 = P.init_sim(cfg, sim, seed=0, device=dev)
    args = (arm, cfg, sim, ref, s0.q, s0.dq, s0.mppi.u_prev, s0.mppi.wp_idx,
            s0.seed, steps)
    eps = (torch.as_tensor(eps_noise(K, (steps, K, T, 2)), device=dev)
           if noise == "eps" else None)
    rec1, uf1 = cuda_sim.fused_sim_run(*args, eps=eps, cluster=1)
    nwarp = cuda_sim.sim_threads(K) // 32
    sizes = [c for c in cuda_sim.CLUSTER_SIZES if c > 1 and nwarp % c == 0]
    assert sizes
    for c in sizes:
        before = cuda_sim.LAUNCHES
        rec, uf = cuda_sim.fused_sim_run(*args, eps=eps, cluster=c)
        assert cuda_sim.LAUNCHES == before + 1
        assert torch.equal(rec, rec1) and torch.equal(uf, uf1), c
    assert bool(torch.isfinite(rec1).all())
    # the default launch is one of them
    rec, uf = cuda_sim.fused_sim_run(*args, eps=eps)
    assert torch.equal(rec, rec1) and torch.equal(uf, uf1)


def test_kernel_chained_equals_single(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=256, horizon=20)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    s0 = P.init_sim(cfg, SIM, seed=3, device=dev)
    _, full = P.simulate_fused(ARM, cfg, SIM, ref, s0, 40)
    s1, r1 = P.simulate_fused(ARM, cfg, SIM, ref, s0, 25)
    s2, r2 = P.simulate_fused(ARM, cfg, SIM, ref, s1, 15)
    for f, a, b1, b2 in zip(full._fields, full, r1, r2):
        assert torch.equal(a, torch.cat([b1, b2])), f
    assert int(s2.step) == 40


def test_kernel_path_end_freeze(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=128, horizon=6)
    ref = torch.as_tensor(P.synth_circle_path(40, revolutions=0.02),
                          device=dev)
    _, rec = P.simulate_fused(ARM, cfg, SIM, ref,
                              P.init_sim(cfg, SIM, seed=0, device=dev), 200)
    done = rec.done.cpu().numpy()
    assert done[-1] and done[int(np.argmax(done)):].all()
    first = int(np.argmax(done))
    q = rec.q[first:].cpu().numpy()
    assert (q == q[0]).all()
    assert (rec.u[first:] == 0).all() and (rec.cost_min[first:] == 0).all()


def test_kernel_rejects_bad_operands(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=64, horizon=5)
    args = list(_args(cfg, dev, 2))
    bad = list(args)
    bad[6] = args[6].double()
    with pytest.raises(TypeError):
        cuda_sim.fused_sim_run_batched(*bad)
    bad = list(args)
    bad[3] = args[3].cpu()
    with pytest.raises(ValueError):
        cuda_sim.fused_sim_run_batched(*bad)
    with pytest.raises(ValueError):
        cuda_sim.fused_sim_run_batched(
            *args, eps=torch.zeros(2, 2, 64, 4, 2, device=dev))


# ---- the per-step solve kernel (csrc/solve_kernel.cu) ----------------------

def _solve_inputs(dev, B, K, T, seed):
    """B scenarios near the preset state, warm-start controls plus noise,
    clamped windows at staggered indices of a 2000-point circle."""
    rng = np.random.default_rng(seed)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    x0 = torch.as_tensor(
        (np.array([*SIM.q0, 0.1, -0.2]) + rng.normal(scale=0.01, size=(B, 4))
         ).astype(np.float32), device=dev)
    u = torch.as_tensor((np.array([10.0, -2.0]) + rng.normal(size=(B, T, 2))
                         ).astype(np.float32), device=dev)
    starts = 3 * torch.arange(B, device=dev) % (2000 - 30)
    idx = starts[:, None] + torch.arange(30, device=dev)
    return x0, u, ref[idx].contiguous()


def _check_solve(got, want, normalize=True):
    """Kernel vs twin on one call: S and m bit for bit (same per-sample
    arithmetic, min is exact); Σwε / u_new to atol 2e-5 (the in-tile sums'
    order differs), raw rows to rtol 2e-5 of their magnitude; eta rtol 2e-5.
    """
    (w_k, s_k, e_k, (m_k, eta_k)), (w_p, s_p, e_p, (m_p, eta_p)) = got, want
    assert torch.equal(s_k, s_p)
    assert torch.equal(m_k, m_p)
    w_p = w_p.cpu().numpy()
    atol = 2e-5 if normalize else 2e-5 * np.abs(w_p).max()
    np.testing.assert_allclose(w_k.cpu().numpy(), w_p, rtol=2e-5, atol=atol)
    np.testing.assert_allclose(eta_k.cpu().numpy(), eta_p.cpu().numpy(),
                               rtol=2e-5)
    if e_p is not None:
        assert torch.equal(e_k, e_p)


@pytest.mark.parametrize("K,T,B", [(1024, 50, 1), (100, 30, 8),
                                   (65536, 50, 1)])
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_solve_kernel_matches_twin(dev, K, T, B, noise):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T,
                              lam=3e5)
    x0, u, win = _solve_inputs(dev, B, K, T, K + T)
    kw = (dict(eps=torch.as_tensor(eps_noise(K, (B, K, T, 2)), device=dev))
          if noise == "eps" else
          dict(seed=torch.arange(B, device=dev) + 7,
               step=torch.arange(B, device=dev) * 5 + 3))
    before = (cuda_solve.LAUNCHES, cuda_solve.COMBINE_LAUNCHES)
    got = cuda_solve.solve_batched(ARM, cfg, x0, u, win, **kw)
    assert (cuda_solve.LAUNCHES, cuda_solve.COMBINE_LAUNCHES) == tuple(
        v + 1 for v in before)
    want = cuda_solve.solve_batched_reference(ARM, cfg, x0, u, win, **kw)
    _check_solve(got, want)
    again = cuda_solve.solve_batched(ARM, cfg, x0, u, win, **kw)
    for a, b in zip((got[0], got[1], *got[3]), (again[0], again[1],
                                                 *again[3])):
        assert torch.equal(a, b)            # deterministic: same bits
    if noise == "prng":
        assert torch.equal(got[2][0], philox_epsilon(7, 3, cfg, dev))


@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_solve_kernel_fleet_shape_fused(dev, noise):
    """simulate_batch's solve at BASELINE config 4: 4096 scenarios x K=128,
    T=30, one tile each, with the fused median and u update; tolerances of
    _check_solve."""
    B, K, T = 4096, 128, 30
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T,
                              lam=3e5)
    x0, u, win = _solve_inputs(dev, B, K, T, 11)
    kw = (dict(eps=torch.as_tensor(eps_noise(5, (B, K, T, 2)), device=dev))
          if noise == "eps" else
          dict(seed=torch.arange(B, device=dev) + 7,
               step=torch.arange(B, device=dev) * 5 + 3))
    got = cuda_solve.solve_batched(ARM, cfg, x0, u, win, fuse_update=True,
                                   **kw)
    want = cuda_solve.solve_batched_reference(ARM, cfg, x0, u, win,
                                              fuse_update=True, **kw)
    _check_solve(got, want)


@pytest.mark.parametrize("T,fuse", [(200, True), (20, False)])
def test_solve_kernel_horizons_and_noise_modes_agree(dev, T, fuse):
    """A long horizon shrinks the tile to fit its noise in shared memory;
    PRNG mode equals eps mode fed the noise it drew, bit for bit."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=1000, horizon=T,
                              lam=3e5)
    x0, u, win = _solve_inputs(dev, 2, 1000, T, 1)
    kw = dict(seed=torch.tensor([1, 2], device=dev), step=4,
              fuse_update=fuse)
    got = cuda_solve.solve_batched(ARM, cfg, x0, u, win, **kw)
    _check_solve(got, cuda_solve.solve_batched_reference(ARM, cfg, x0, u,
                                                         win, **kw))
    fed = cuda_solve.solve_batched(ARM, cfg, x0, u, win, eps=got[2],
                                   fuse_update=fuse)
    for a, b in zip((got[0], got[1], *got[3]), (fed[0], fed[1], *fed[3])):
        assert torch.equal(a, b)


def test_solve_kernel_raw_rows_with_k_offset(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=2048, horizon=50,
                              exploration=0.5, lam=3e5)
    x0, u, win = _solve_inputs(dev, 2, 700, 50, 2)
    kw = dict(seed=torch.tensor([3, 4], device=dev), step=9, k_local=700,
              k_offset=torch.tensor([0, 900], device=dev), normalize=False)
    got = cuda_solve.solve_batched(ARM, cfg, x0, u, win, **kw)
    _check_solve(got, cuda_solve.solve_batched_reference(ARM, cfg, x0, u,
                                                         win, **kw),
                 normalize=False)
    full = philox_epsilon(4, 9, cfg, dev)
    assert torch.equal(got[2][1], full[900:1600])


@pytest.mark.parametrize("K,T,B", [
    (1024, 50, 1),     # 4 lanes a sample on an H100, 32 tiles of 32
    (1024, 50, 8),     # 2 lanes
    (1024, 50, 64),    # 1 lane
    (100, 30, 8),      # 4 lanes, one tile of 128
    (8192, 50, 1)])    # 2 lanes, tiles of 64
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_solve_kernel_every_layout_matches_twin(dev, K, T, B, noise):
    """At shapes that take each lanes per sample solve_layout can pick: S
    and m bit for bit against the twin, Σwε / η within _check_solve's
    tolerances."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T,
                              lam=3e5)
    x0, u, win = _solve_inputs(dev, B, K, T, 7 * B)
    kw = (dict(eps=torch.as_tensor(eps_noise(K, (B, K, T, 2)), device=dev))
          if noise == "eps" else
          dict(seed=torch.arange(B, device=dev) + 2,
               step=torch.arange(B, device=dev) + 1))
    got = cuda_solve.solve_batched(ARM, cfg, x0, u, win, fuse_update=True,
                                   **kw)
    want = cuda_solve.solve_batched_reference(ARM, cfg, x0, u, win,
                                              fuse_update=True, **kw)
    _check_solve(got, want)


@pytest.mark.parametrize("K,T,B", [(1024, 50, 64), (1024, 50, 8),
                                   (128, 30, 64)])
def test_solve_kernel_batch_equals_single(dev, K, T, B):
    """Scenario 0 of a batch gives the bits of its solve alone, though the
    two take different lanes per sample (at K=1024: 1 or 2 against 4)."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T,
                              lam=3e5)
    x0, u, win = _solve_inputs(dev, B, K, T, K)
    kw = dict(seed=torch.arange(B, device=dev) + 9,
              step=torch.full((B,), 4, device=dev), fuse_update=True)
    many = cuda_solve.solve_batched(ARM, cfg, x0, u, win, **kw)
    alone = cuda_solve.solve_batched(
        ARM, cfg, x0[:1], u[:1], win[:1], fuse_update=True,
        seed=kw["seed"][:1], step=kw["step"][:1])
    for a, b in zip((many[0], many[1], *many[3]),
                    (alone[0], alone[1], *alone[3])):
        assert torch.equal(a[:1], b)


def test_solve_kernel_tiles_give_the_same_costs(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=3000, horizon=30,
                              lam=3e5)
    x0, u, win = _solve_inputs(dev, 1, 3000, 30, 3)
    outs = [cuda_solve.solve_batched(ARM, cfg, x0, u, win, seed=[5],
                                     tile=tile) for tile in (32, 128, 512)]
    for o in outs[1:]:
        assert torch.equal(o[1], outs[0][1])
        np.testing.assert_allclose(o[0].cpu().numpy(),
                                   outs[0][0].cpu().numpy(), atol=2e-5)


def test_per_step_loop_matches_fused_and_batch_matches_single(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=256, horizon=20)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    s0 = P.init_sim(cfg, SIM, seed=3, device=dev)
    before = cuda_solve.LAUNCHES
    _, per = P.simulate(ARM, cfg, SIM, ref, s0, 8, backend="cuda")
    assert cuda_solve.LAUNCHES == before + 8
    _, fused = P.simulate_fused(ARM, cfg, SIM, ref, s0, 8)
    for i in range(8):
        np.testing.assert_allclose(per.q[i].cpu().numpy(),
                                   fused.q[i].cpu().numpy(),
                                   atol=2e-6 * 4 ** i)
        np.testing.assert_allclose(per.u[i].cpu().numpy(),
                                   fused.u[i].cpu().numpy(),
                                   atol=2e-5 * 4 ** i)
    assert torch.equal(per.wp_idx, fused.wp_idx)
    states = P.init_sim_batch(cfg, SIM, [3, 8, 1], device=dev)
    _, rec = P.simulate_batch(ARM, cfg, SIM, ref, states, 8, backend="cuda")
    for f, a, b in zip(rec._fields, rec, per):
        assert torch.equal(a[:, 0], b), f


def test_solve_kernel_rejects_bad_operands(dev):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=64, horizon=5)
    x0, u, win = _solve_inputs(dev, 2, 64, 5, 4)
    with pytest.raises(TypeError):
        cuda_solve.solve_batched(ARM, cfg, x0.double(), u, win, seed=[1, 2])
    with pytest.raises(ValueError):
        cuda_solve.solve_batched(ARM, cfg, x0, u, win.cpu(), seed=[1, 2])
    with pytest.raises(ValueError):
        cuda_solve.solve_batched(ARM, cfg, x0, u, win,
                                 eps=torch.zeros(2, 64, 4, 2, device=dev))
    with pytest.raises(ValueError):
        cuda_solve.solve_batched(ARM, cfg, x0, u, win, seed=[1, 2],
                                 fuse_update=True, normalize=False)
    with pytest.raises(ValueError):
        cuda_solve.solve_batched(ARM, cfg, x0, u, win, seed=[1, 2],
                                 tile=544)


# ---- the fleet kernel (csrc/fleet_kernel.cu) --------------------------------

def _fleet_args(cfg, dev, B, rows, frozen_mix):
    """B scenarios on a ``rows``-row path; with ``frozen_mix`` the odd ones
    start at the last row, so frozen and active scenarios share a block."""
    ref = torch.as_tensor(P.synth_circle_path(2000)[:rows], device=dev)
    f32 = torch.float32
    q0 = (torch.tensor([SIM.q0], dtype=f32, device=dev).repeat(B, 1)
          + 0.005 * torch.arange(B, device=dev)[:, None])
    wp = torch.zeros(B, dtype=torch.int64, device=dev)
    if frozen_mix:
        wp[1::2] = rows - 1
    return (ARM, cfg, SIM, ref, q0, torch.zeros(B, 2, device=dev),
            torch.tensor(cfg.warm_start, dtype=f32,
                         device=dev).repeat(B, cfg.horizon, 1).contiguous(),
            wp, torch.arange(B, device=dev) + 3)


@pytest.mark.parametrize("K,B,group,rows,mix,T", [
    (128, 16, 8, 120, True, 30), (100, 12, 4, 2000, False, 30),
    (40, 6, 2, 400, True, 30),
    (128, 16, 8, 400, True, 25),      # odd T: the float4 window's stride
    (90, 8, 8, 400, False, 31),       # two warps of two samples a lane
    (20, 8, 4, 400, True, 31)])       # K < 32: one slot, padded
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_fleet_kernel_equals_sim_kernel(dev, K, B, group, rows, mix, T,
                                        noise):
    """Per scenario, records and u_final of the fleet kernel equal the
    fused kernel's bit for bit (frozen/active mix, padding, odd T), at
    shapes that take every layout of the fleet kernel: one warp a scenario
    (K=20), two (K=40; two samples a lane at K=90) and four (K=100, 128).
    At odd T several scenarios share a block, so a window off its 16-byte
    boundary would fault on its float4 loads."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T)
    steps = 20
    args = _fleet_args(cfg, dev, B, rows, mix)
    kw = dict(step0=torch.arange(B, device=dev) * 2,
              eps=(torch.as_tensor(eps_noise(K, (B, steps, K, T, 2)),
                                   device=dev) if noise == "eps" else None))
    rec1, uf1 = cuda_sim.fused_sim_run_batched(*args, steps, group=1, **kw)
    before = cuda_sim.FLEET_LAUNCHES
    recg, ufg = cuda_sim.fused_sim_run_batched(*args, steps, group=group,
                                               **kw)
    assert cuda_sim.FLEET_LAUNCHES == before + 1
    assert torch.equal(recg, rec1) and torch.equal(ufg, uf1)
    again = cuda_sim.fused_sim_run_batched(*args, steps, group=group, **kw)
    assert torch.equal(again[0], recg) and torch.equal(again[1], ufg)
    if mix:
        done = recg[:, -1, 7].cpu().numpy()
        assert (done[1::2] == 1).all() and (done[0::2] == 0).all()


@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_fleet_kernel_matches_stacked_twin(dev, noise):
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=128, horizon=30)
    steps, B = 6, 16
    args = _fleet_args(cfg, dev, B, 120, True)
    eps = (torch.as_tensor(eps_noise(3, (B, steps, 128, 30, 2)), device=dev)
           if noise == "eps" else None)
    rec_k, _ = cuda_sim.fused_sim_run_batched(*args, steps, eps=eps, group=8)
    rec_p, _ = cuda_sim.fused_sim_reference_stacked(*args, steps, eps=eps)
    rk, rp = rec_k.cpu().numpy(), rec_p.cpu().numpy()
    for i in range(steps):
        np.testing.assert_allclose(rk[:, i, 0:2], rp[:, i, 0:2],
                                   atol=2e-6 * 4 ** i)
        np.testing.assert_allclose(rk[:, i, 4:6], rp[:, i, 4:6],
                                   atol=2e-5 * 4 ** i)
    np.testing.assert_array_equal(rk[..., 6:8], rp[..., 6:8])
    np.testing.assert_allclose(rk[:, 0, 8:12], rp[:, 0, 8:12], rtol=1e-4)


def test_simulate_fused_batch_on_the_card(dev):
    """The fleet loop: launches the fleet kernel, each scenario equals its
    simulate_fused run alone, chained equals one run; K > 128 takes the
    fused kernel."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=128, horizon=30)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    states = P.init_sim_batch(cfg, SIM, [3, 8, 1, 5, 0, 2, 9, 4], device=dev)
    before = cuda_sim.FLEET_LAUNCHES
    final, rec = P.simulate_fused_batch(ARM, cfg, SIM, ref, states, 30)
    assert cuda_sim.FLEET_LAUNCHES == before + 1
    _, alone = P.simulate_fused(ARM, cfg, SIM, ref,
                                P.init_sim(cfg, SIM, seed=1, device=dev), 30)
    for f, a, b in zip(rec._fields, rec, alone):
        assert torch.equal(a[:, 2], b), f
    s1, r1 = P.simulate_fused_batch(ARM, cfg, SIM, ref, states, 12)
    s2, r2 = P.simulate_fused_batch(ARM, cfg, SIM, ref, s1, 18)
    for f, a, b1, b2 in zip(rec._fields, rec, r1, r2):
        assert torch.equal(a, torch.cat([b1, b2])), f
    assert torch.equal(s2.step, final.step)
    big = dataclasses.replace(cfg, num_samples=256)
    before = (cuda_sim.LAUNCHES, cuda_sim.FLEET_LAUNCHES)
    P.simulate_fused_batch(ARM, big, SIM, ref, states, 2, group=8)
    assert (cuda_sim.LAUNCHES, cuda_sim.FLEET_LAUNCHES) == (before[0] + 1,
                                                            before[1])
