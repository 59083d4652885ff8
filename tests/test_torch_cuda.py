"""The fused closed-loop CUDA kernel against its plain PyTorch twin, on the
card.  Marked ``cuda``: without an NVIDIA GPU (and nvcc) every test skips.
The file imports nothing of JAX, so on a GPU machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_sim

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
