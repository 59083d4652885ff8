"""The step tail's statistics order and layout (``ops/cuda_step.py``):
``tail_stats_ordered``, the kernel's order of the sums over K in torch
ops, and ``step_tail_layout``, how the kernel lays that order out on the
card.

On the CPU:
* the order twin against a float64 reference (min exact; mean, ESS and
  entropy within the float32 error of the order's longest chain of sums,
  :func:`chain_rtol`), at K = 30, 100, 128, 1000, 1024, 4096 and 20000
  (one, four and twenty samples a logical lane);
* a scenario's bits are the same alone and inside a batch of 64;
* every layout covers the order's logical warps inside a block the kernel
  takes, for K from 1 to 65536 and batches from 1 to 4096;
* the per-step loop's chunk runs one head and n tails, n - 1 of them
  carrying the next head, through the plain versions (counted by
  monkeypatching).

Marked ``cuda`` and skipped without a card: the kernel's min, mean, ESS
and entropy equal the twin's on the card bit for bit at those K and B = 1
and 64, and every layout the kernel is built for (both builds where K
allows, blocks of 1, 2 and 4 scenarios) gives the default layout's bits
in every output, the carried head included.  The file
imports nothing of JAX, so on a GPU machine:

    python -m pytest --noconftest tests/test_torch_step_order.py -m cuda
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_step
from mppi_robotarm_tpu_torch.sim import loop as ploop

torch.set_num_threads(1)
ARM, SIM = P.ArmParams(), P.SimConfig()
KS = [30, 100, 128, 1000, 1024, 4096, 20000]
LAMS = [100.0, 5e4]       # a few samples weigh; hundreds weigh


def _costs(B, K, seed=0, device="cpu"):
    """(B, K) float32 costs like a solve's: a floor and a spread that
    varies by scenario."""
    rng = np.random.default_rng(seed)
    floor = rng.uniform(50.0, 400.0, size=(B, 1))
    spread = rng.uniform(10.0, 3000.0, size=(B, 1))
    s = floor + spread * rng.random(size=(B, K)) ** 2
    return torch.as_tensor(s.astype(np.float32), device=device)


def chain_rtol(K):
    """The float32 error of the order's longest chain of sums: a logical
    lane's ceil(K / n) samples, five butterfly levels, n / 32 warps, and
    a few roundings of exp, the division, the square and the log."""
    n = cuda_step.step_tail_threads(K)
    return (-(-K // n) + 5 + n // 32 + 8) * 2.0 ** -23


def reference64(s, lam):
    """(min, mean, ESS, entropy) of float32 costs in float64."""
    x = s.double()
    inv_lam = float(np.float32(1.0) / np.float32(lam))
    e = torch.exp(-(x - x.amin(-1, keepdim=True)) * inv_lam)
    w = e / e.sum(-1, keepdim=True)
    ent = -torch.where(w > 0, w * torch.log(w), torch.zeros_like(w)).sum(-1)
    return x.amin(-1), x.mean(-1), 1.0 / (w * w).sum(-1), ent


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("K", KS)
def test_twin_agrees_with_a_float64_reference(K, lam):
    s = _costs(3, K, seed=K)
    got = cuda_step.tail_stats_ordered(s, lam)
    want = reference64(s, lam)
    rtol = chain_rtol(K)
    assert torch.equal(got[0].double(), want[0])
    for name, g, w, floor in zip(("mean", "ess", "entropy"), got[1:],
                                 want[1:], (0.0, 0.0, math.log(K))):
        assert g.dtype == torch.float32
        rel = ((g.double() - w).abs() / w.abs().clamp_min(floor)).max()
        assert rel <= rtol, (name, float(rel), rtol)


@pytest.mark.parametrize("K", KS)
def test_a_scenario_alone_equals_it_in_a_batch(K):
    s = _costs(64, K, seed=1)
    whole = cuda_step.tail_stats_ordered(s, 100.0)
    for b in (0, 17, 63):
        alone = cuda_step.tail_stats_ordered(s[b:b + 1].clone(), 100.0)
        for a, w in zip(alone, whole):
            assert torch.equal(a, w[b:b + 1])


@pytest.mark.parametrize("K", [1, 31, 32, 33, 100, 128, 200, 500, 1000,
                               1024, 1025, 2000, 4096, 4097, 16384, 16385,
                               65536])
@pytest.mark.parametrize("B,sms", [(1, 132), (64, 132), (4096, 132),
                                   (3, None), (300, 8)])
def test_tail_layout_covers_the_order(K, B, sms):
    """A layout the kernel takes (``tail_layout_fits``: built for its
    lanes and cap, a block within its threads, at most 15 scenarios where
    they need named barriers), whose warps hold every logical warp of the
    order and whose registers hold a logical lane's samples (or cap 0)."""
    lay = cuda_step.step_tail_layout(K, B, sms)
    n = cuda_step.step_tail_threads(K)
    assert cuda_step.tail_layout_fits(lay)
    assert lay.warps == -(-(n // 32) // lay.lanes)
    assert lay.cap == 0 or lay.cap >= -(-K // n)
    assert 1 <= lay.group <= B


@pytest.mark.parametrize("lanes,cap,warps,group,fits", [
    (4, 1, 8, 2, True), (4, 1, 8, 3, False), (4, 1, 1, 16, True),
    (4, 1, 1, 17, False), (2, 0, 16, 1, True), (2, 0, 16, 2, False),
    (2, 0, 1, 9, True), (2, 0, 1, 10, False), (1, 1, 17, 1, False),
    (2, 1, 16, 1, False), (4, 0, 8, 1, False), (2, 16, 16, 1, False)])
def test_tail_layout_fits_what_the_kernel_takes(lanes, cap, warps, group,
                                                fits):
    assert cuda_step.tail_layout_fits(
        cuda_step.TailLayout(warps, lanes, group, cap)) is fits


def test_tail_layout_at_the_main_path_shapes():
    assert cuda_step.step_tail_layout(1024, 1, 132) == (8, 4, 1, 1)
    assert cuda_step.step_tail_layout(128, 4096, 132) == (1, 4, 4, 1)


def test_a_chunk_runs_one_head_and_a_tail_a_step(monkeypatch):
    """``_steps_into`` over a chunk of n steps on the CPU: the wrappers
    see one head and n tails, n - 1 with ``carry_head``; the plain
    versions run n heads (the chunk's and the carried ones) and n
    tails."""
    calls = {"head": 0, "tail": 0, "carry": 0, "plain_head": 0,
             "plain_tail": 0}

    def counted(fn, key):
        def run(*a, **k):
            calls[key] += 1
            if key == "tail":
                calls["carry"] += int(k.get("carry_head", False))
            return fn(*a, **k)
        return run

    for name, key in (("step_head", "head"), ("step_tail", "tail"),
                      ("step_head_plain", "plain_head"),
                      ("step_tail_plain", "plain_tail")):
        monkeypatch.setattr(cuda_step, name,
                            counted(getattr(cuda_step, name), key))
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=32, horizon=6)
    ref = torch.as_tensor(P.synth_circle_path(500), dtype=torch.float32)
    states = P.init_sim_batch(cfg, SIM, [1, 2], device="cpu")
    n = 5
    rows = ploop._row_buffers(n, states, ref)
    states = states._replace(seed=torch.as_tensor(states.seed))
    ploop._steps_into(ARM, cfg, SIM, ref, states, states.step.clone(),
                      None, rows)
    assert calls == {"head": 1, "tail": n, "carry": n - 1,
                     "plain_head": n, "plain_tail": n}


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step tail runs on the card")
    return torch.device("cuda", 0)


def _tail_inputs(K, B, device, seed=0, T=8):
    """A step's tail inputs on the 2000-point circle, none frozen (so the
    statistics are written), scenarios near the path end among them:
    (cfg, ref, state, wp_new, path_end, u_seq, s, clock)."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=device)
    f = lambda *shape, scale=1.0: torch.as_tensor(
        (rng.normal(size=shape) * scale).astype(np.float32), device=device)
    q = torch.as_tensor((np.array([SIM.q0]) + 0.05 * rng.normal(
        size=(B, 2))).astype(np.float32), device=device)
    wp = torch.as_tensor(rng.integers(0, 1990, size=B), device=device)
    wp[-1:] = 1998
    state = (torch.zeros(B, dtype=torch.int64, device=device), q,
             f(B, 2, scale=0.3), f(B, T, 2, scale=5.0), wp,
             torch.zeros(B, dtype=torch.bool, device=device))
    h = cuda_step.step_head(cfg, ref, q, state[2], wp)
    clock = torch.as_tensor(rng.integers(0, 1999, size=B), device=device)
    return (cfg, ref, state, h[1], h[2], f(B, T, 2, scale=5.0),
            _costs(B, K, seed, device), clock)


def _run_tail(cfg, ref, state, wp_new, path_end, u_seq, s, clock,
              layout=None):
    """The tail kernel carrying the head, in ``layout`` (None: the
    package's); returns its results and record row."""
    B = s.shape[0]
    row = tuple(r[0] for r in ploop._row_buffers(
        1, ploop._as_state((*state[:5], None, state[5])), ref))
    if layout is None:
        out = cuda_step.step_tail(ARM, cfg, SIM, ref, *state, wp_new,
                                  path_end, u_seq, s, clock, row,
                                  carry_head=True)
    else:
        out = cuda_step._tail_launch(ARM, cfg, SIM, ref, state, wp_new,
                                     path_end, u_seq, s, clock, row,
                                     carry_head=True, layout=layout)
    torch.cuda.synchronize()
    assert row[0].shape[0] == B
    return out, row


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("K", KS)
def test_kernel_statistics_equal_the_twin_on_the_card(dev, K, B):
    args = _tail_inputs(K, B, dev, seed=K + B)
    _, row = _run_tail(*args)
    want = cuda_step.tail_stats_ordered(args[6], args[0].lam)
    fields = dict(zip(P.SimRecord._fields, row))
    for name, w in zip(("cost_min", "cost_mean", "ess", "weight_entropy"),
                       want):
        assert torch.equal(fields[name], w), name


def _layouts(K, B):
    """Every layout of ``step_tail_kernel`` for K and B: each build that
    holds a logical lane's samples, in blocks of 1, 2 and 4 scenarios,
    that the kernel takes."""
    n = cuda_step.step_tail_threads(K)
    out = []
    for lanes, cap in sorted(cuda_step.TAIL_BUILT):
        if cap and -(-K // n) > cap:
            continue
        warps = -(-(n // 32) // lanes)
        for group in (1, 2, 4):
            lay = cuda_step.TailLayout(warps, lanes, group, cap)
            if group <= B and cuda_step.tail_layout_fits(lay):
                out.append(lay)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", [(1024, 1), (1024, 64), (128, 300),
                                 (100, 8), (30, 5), (4096, 3), (20000, 2)])
def test_every_tail_layout_gives_the_same_bits(dev, K, B):
    args = _tail_inputs(K, B, dev, seed=7)
    want = _run_tail(*args)
    layouts = _layouts(K, B)
    assert len(layouts) > 1 or K > 1024
    for lay in layouts:
        (*state, head), row = _run_tail(*args, layout=lay)
        for a, b in zip((*state, *head, *row),
                        (*want[0][:7], *want[0][7], *want[1])):
            assert torch.equal(a, b), lay
