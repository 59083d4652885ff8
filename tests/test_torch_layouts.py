"""The host-side layout choices of the redesigned kernels, on the CPU: the
solve tile pass's threads per sample, tile and tiles per block
(``cuda_solve.solve_lanes``, ``solve_tile``, ``solve_layout`` and
``_plan``; the tile depends on K and the config alone, never on the batch
or the card) and the fleet kernel's
warps per scenario (``cuda_sim.fleet_warps``).  The kernels themselves run
in ``tests/test_torch_cuda.py`` on the card, at shapes that take each
layout."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve

H100_SMS = 132
CFG = P.benchmark_preset()[1]           # K=1024, H=50
CSRC = Path(cuda_sim.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("B,K,sms,lanes", [
    (1, 1024, H100_SMS, 4),      # benchmark_preset's per-step solve
    (1, 4096, H100_SMS, 4),      # 16384 threads <= 132 x 128
    (1, 8192, H100_SMS, 2),
    (1, 65536, H100_SMS, 1),     # BASELINE config 3
    (4096, 128, H100_SMS, 1),    # the fleet's per-step solve
    (8, 100, H100_SMS, 4),
    (1, 1024, 8, 1),             # a small card: no idle SMs to fill
    (1, 1024, 16, 2),
])
def test_solve_lanes_fill_idle_schedulers(B, K, sms, lanes):
    assert cuda_solve.solve_lanes(B, K, sms) == lanes
    assert lanes == 1 or B * K * lanes <= sms * cuda_solve.SM_THREADS


@pytest.mark.parametrize("B,K,T,sms,tile,lanes,group", [
    (1, 1024, 50, H100_SMS, 32, 4, 1),    # 32 blocks of 128 threads
    (8, 1024, 50, H100_SMS, 32, 2, 2),    # the same tiles at any batch
    (64, 1024, 50, H100_SMS, 32, 1, 4),   # 4 one-warp tiles a block
    (1, 8192, 50, H100_SMS, 64, 2, 1),
    (1, 65536, 50, H100_SMS, 512, 1, 1),  # the parent's 128 tiles of 512
    (4096, 128, 30, H100_SMS, 128, 1, 1),  # one tile a scenario, as before
    (1, 128, 30, H100_SMS, 128, 4, 1),    # one block of 512 threads
    (8, 100, 30, H100_SMS, 128, 4, 1),
    (1, 1024, 50, 114, 32, 4, 1),         # a 114-SM card: the same tiles
    (1, 1024, 50, None, 32, 1, 4),        # CPU tensors: the same tiles
    (1, 65536, 50, None, 512, 1, 1),
    (1, 40, 50, None, 128, 1, 1),         # small K: one default tile
])
def test_solve_layout_by_shape_and_card(B, K, T, sms, tile, lanes, group):
    cfg = dataclasses.replace(CFG, num_samples=K, horizon=T)
    assert cuda_solve.solve_layout(cfg, K, B, sms) == (tile, lanes, group)
    assert cuda_solve._plan(cfg, K, None, True, True, B, sms) == (
        tile, -(-K // tile), lanes, group)
    assert group * tile * lanes <= cuda_solve.MAX_THREADS


@pytest.mark.parametrize("K,T", [(1024, 50), (128, 30), (100, 30),
                                 (4096, 50), (8192, 50), (65536, 50)])
@pytest.mark.parametrize("sms", [H100_SMS, 114, 16, None])
def test_solve_tile_does_not_depend_on_the_batch(K, T, sms):
    """The tile sets the cross-tile sums' rounding: a scenario alone and in
    a batch of any size, on any card or the CPU, takes the same tile, so
    the same bits."""
    cfg = dataclasses.replace(CFG, num_samples=K, horizon=T)
    tiles = {cuda_solve.solve_layout(cfg, K, B, sms)[0]
             for B in (1, 2, 8, 64, 4096)}
    assert tiles == {cuda_solve.solve_tile(cfg, K)}


def test_solve_layout_explicit_tile():
    # an explicit tile keeps the most lanes that fit 512 threads
    assert cuda_solve.solve_layout(CFG, 1024, 1, H100_SMS, tile=256) == (
        256, 2, 1)
    assert cuda_solve.solve_layout(CFG, 1024, 1, H100_SMS, tile=512) == (
        512, 1, 1)
    assert cuda_solve.solve_layout(CFG, 1024, 64, H100_SMS, tile=128) == (
        128, 1, 1)
    # a block holds no more tiles than the scenario has
    assert cuda_solve.solve_layout(CFG, 40, 1, None, tile=32) == (32, 1, 2)
    assert cuda_solve.solve_layout(CFG, 1024, 64, H100_SMS, tile=64) == (
        64, 1, 2)
    # a long horizon caps the tile that lanes > 1 would take, and the
    # samples a block holds
    long = dataclasses.replace(CFG, horizon=500)
    assert cuda_solve.solve_layout(long, 1024, 1, H100_SMS) == (32, 4, 1)
    assert cuda_solve.solve_layout(long, 1024, 64, H100_SMS) == (32, 1, 1)
    assert cuda_solve._max_tile(long) == 32


def test_solve_twin_takes_the_kernels_tiles_on_the_cpu():
    """CPU tensors run the plain version on solve_tile's tiles (32 at
    K=1024), so its cross-tile sums round as the kernel's do."""
    cfg = dataclasses.replace(CFG, lam=3e5)
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor(np.array([[1.15, -1.27, 0.1, -0.2]], np.float32))
    u = torch.as_tensor(rng.normal(size=(1, 50, 2)).astype(np.float32))
    win = torch.as_tensor(P.synth_circle_path(400)[None, :cfg.search_idx_len])
    got = cuda_solve.solve_batched(P.ArmParams(), cfg, x0, u, win, seed=[4],
                                   fuse_update=True, emit_eps=False)
    want = cuda_solve.solve_batched(P.ArmParams(), cfg, x0, u, win, seed=[4],
                                    tile=32, fuse_update=True, emit_eps=False)
    for a, b in zip((got[0], got[1], *got[3]), (want[0], want[1], *want[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,warps", [(1, 1), (20, 1), (32, 1), (33, 2),
                                     (40, 2), (64, 2), (65, 2), (90, 2),
                                     (96, 2), (97, 4), (100, 4), (128, 4)])
def test_fleet_warps_hold_at_most_two_samples_a_lane(K, warps):
    """One warp for one 32-sample slot, two warps for two or three slots
    (two samples a lane at three), four warps for four (one a lane):
    every warp holds samples, and no lane carries the four that spilled."""
    assert cuda_sim.fleet_warps(K) == warps
    slots = -(-K // 32)
    assert -(-slots // warps) <= 2
    assert 32 * (warps - 1) < K


def test_fleet_kernel_takes_no_layout_keyword():
    """The fleet's layout follows K alone: there is no keyword to force
    it, and CPU tensors run the stacked plain version."""
    _, cfg, sim = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=128, horizon=6)
    B = 2
    args = (P.ArmParams(), cfg, sim,
            torch.as_tensor(P.synth_circle_path(400)), torch.zeros(B, 2),
            torch.zeros(B, 2), torch.zeros(B, 6, 2),
            torch.zeros(B, dtype=torch.int64),
            torch.zeros(B, dtype=torch.int64), 1)
    with pytest.raises(TypeError):
        cuda_sim.fused_sim_run_batched(*args, group=2, warps=2)
    rec, _ = cuda_sim.fused_sim_run_batched(*args, group=2)
    assert rec.shape == (B, 1, cuda_sim.REC_LANES)


@pytest.mark.parametrize("T", [25, 30, 31, 50])
@pytest.mark.parametrize("W", [7, 30, 40])
def test_fleet_scenario_stride_keeps_the_window_16_byte_aligned(T, W):
    """fleet_kernel's shared floats per scenario, evaluated from the
    kernel's own source: a multiple of 4 at odd T too, so that each
    scenario's float4 window rows start on a 16-byte boundary, and room
    for the window, both u buffers, the Σwε rows, the partials and the
    softmax numerators."""
    src = (CSRC / "fleet_kernel.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (kMaxSlots) = (\d+);", src)}
    consts["kPartFloats"] = int(re.search(
        r"constexpr int kPartFloats = (\d+) \* kMaxSlots;", src).group(1)
        ) * consts["kMaxSlots"]
    expr = re.search(r"int smem_floats_per_scenario\(const SimParams& p\) "
                     r"\{\s*return (.*?);", src, re.S).group(1)
    expr = expr.replace("p.W", str(W)).replace("p.T", str(T))
    for name, v in consts.items():
        expr = expr.replace(name, str(v))
    assert re.fullmatch(r"[\d\s+*/()]+", expr), expr
    floats = eval(expr.replace("/", "//"))   # C int division, all positive
    assert floats % 4 == 0
    assert 4 * W + 6 * T + 5 * 4 + 4 * 32 <= floats < (
        4 * W + 6 * T + 5 * 4 + 4 * 32 + 4)
