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
* every layout covers the order's logical warps inside a block (or a
  cluster of blocks) the kernel takes, for K from 1 to 65536 and batches
  from 1 to 4096; above K = 1024 a scenario takes a cluster of 8 CTAs
  while the batch's clusters fit the card's SMs, and the clustered build
  is held to what its launch takes;
* the per-step loop's chunk runs one head and n tails, n - 1 of them
  carrying the next head, through the plain versions (counted by
  monkeypatching).

Marked ``cuda`` and skipped without a card: the kernel's min, mean, ESS
and entropy equal the twin's on the card bit for bit at those K and B = 1
and 64, and on a cluster at K = 4096, 20000 and 65536, B = 1 and 2; every
layout the kernel is built for (each build where K allows, blocks of 1,
2 and 4 scenarios, the clustered build on its cluster) gives the default
layout's bits in every output, the carried head included; a 4000-step
chain of ``simulate(backend="cuda")`` at K = 65536 records the same bits
with the tail on a cluster as in the one-block layout that reads S each
pass; and ``CLUSTER_TAILS`` counts every tail of a large-K loop and none
of a K = 1024 loop.  The file
imports nothing of JAX, so on a GPU machine:

    python -m pytest --noconftest tests/test_torch_step_order.py -m cuda
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.mppi import solver as psolver
from mppi_robotarm_tpu_torch.ops import cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.utils import cuda_graphs

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
    order and whose registers hold a logical lane's samples (or cap 0),
    on a card that places a cluster of 8 CTAs on every 8 of its SMs."""
    slots = (sms or 0) // cuda_step.TAIL_CLUSTER
    lay = cuda_step.step_tail_layout(K, B, sms, slots)
    n = cuda_step.step_tail_threads(K)
    assert cuda_step.tail_layout_fits(lay, K)
    assert lay.warps == -(-(n // 32) // (lay.lanes * lay.cluster))
    assert lay.cap == 0 or lay.cap >= -(-K // n)
    assert 1 <= lay.group <= B
    assert lay.cluster == 1 or B <= slots * (
        -(-K // n) // cuda_step.CLUSTER_WAVE_SAMPLES)


@pytest.mark.parametrize("lanes,cap,warps,group,fits", [
    (4, 1, 8, 2, True), (4, 1, 8, 3, False), (4, 1, 1, 16, True),
    (4, 1, 1, 17, False), (2, 0, 16, 1, True), (2, 0, 16, 2, False),
    (2, 0, 1, 9, True), (2, 0, 1, 10, False), (1, 1, 17, 1, False),
    (2, 1, 16, 1, False), (4, 0, 8, 1, False), (2, 16, 16, 1, False)])
def test_tail_layout_fits_what_the_kernel_takes(lanes, cap, warps, group,
                                                fits):
    assert cuda_step.tail_layout_fits(
        cuda_step.TailLayout(warps, lanes, group, cap)) is fits


@pytest.mark.parametrize("warps,lanes,group,cap,cluster,K,fits", [
    (4, 1, 1, 64, 8, 65536, True), (4, 1, 1, 64, 8, 4096, True),
    (4, 1, 1, 64, 8, None, True),
    (4, 1, 1, 64, 6, None, False),         # a cluster not a power of two
    (2, 1, 1, 64, 16, None, False),        # more than 8 CTAs
    (4, 1, 1, 64, 8, 70000, False),        # 69 samples a logical lane
    (4, 1, 2, 64, 8, None, False),         # two scenarios on a cluster
    (8, 1, 1, 64, 4, None, False),         # 4 CTAs
    (5, 1, 1, 64, 8, None, False),         # 40 logical warps
    (4, 1, 1, 64, 8, 992, False),          # fewer than 1024 logical lanes
    (32, 1, 1, 64, 1, None, False),        # the clustered build alone
    (16, 2, 1, 0, 8, None, False), (8, 4, 1, 1, 2, None, False),
    (4, 1, 1, 32, 8, None, False)])        # a cap not built
def test_clustered_tail_layout_fits_what_the_kernel_takes(
        warps, lanes, group, cap, cluster, K, fits):
    """The clustered build (``CLUSTER_BUILD``, only on a cluster): 8
    CTAs, one scenario a cluster, its warps splitting all 1024 logical
    lanes evenly over them, and a cap that holds K."""
    lay = cuda_step.TailLayout(warps, lanes, group, cap, cluster)
    assert cuda_step.tail_layout_fits(lay, K) is fits


def test_tail_layout_at_the_main_path_shapes():
    assert cuda_step.step_tail_layout(1024, 1, 132) == (8, 4, 1, 1, 1)
    assert cuda_step.step_tail_layout(128, 4096, 132) == (1, 4, 4, 1, 1)


@pytest.mark.parametrize("K", [16384, 20000, 65536])
@pytest.mark.parametrize("B", [1, 2])
def test_tail_layout_above_1024_takes_a_cluster(K, B):
    """K > 1024, 16 samples a logical lane or more, at B clusters within
    the 15 of the clustered build that the H100 (132 SMs) holds at once:
    four statistics warps a CTA, one logical lane a lane holding its
    samples, 8 CTAs."""
    assert cuda_step.step_tail_layout(K, B, 132, 15) == (4, 1, 1, 64, 8)


@pytest.mark.parametrize("K,B", [(65536, 60), (49152, 45), (32768, 30),
                                 (16384, 15)])
def test_tail_layout_takes_a_wave_of_clusters_for_each_16_samples(K, B):
    """As many waves of 15 clusters as a logical lane has 16 samples:
    four at K = 65536, one at 16384."""
    assert cuda_step.step_tail_layout(K, B, 132, 15) == (4, 1, 1, 64, 8)


@pytest.mark.parametrize("K,B,slots", [
    (65536, 64, 15), (4096, 4096, 15), (65537, 1, 15), (65536, 1, 0),
    (4096, 16, 15), (4096, 1, 15), (15360, 1, 15), (16384, 16, 15),
    (32768, 31, 15), (65536, 61, 15)])
def test_tail_layout_keeps_one_block_where_clusters_do_not_fit(K, B, slots):
    """More waves of clusters than a logical lane's samples pay for (none
    below 16 a logical lane), a logical lane's samples past the cap, or a
    card that places no cluster: 16 statistics warps of two logical lanes
    a lane in one block, reading S each pass."""
    lay = cuda_step.step_tail_layout(K, B, 132, slots)
    assert (lay.warps, lay.lanes, lay.cap, lay.cluster) == (16, 2, 0, 1)


def test_off_the_card_the_tail_takes_no_cluster():
    """Off the card there are no cluster slots, so the layout the wrapper
    resolves keeps a large-K scenario in one block."""
    cpu = torch.device("cpu")
    assert cuda_step._cluster_slots(cpu) == 0
    assert cuda_step._tail_layout_on(65536, 1, cpu).cluster == 1


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


def _solve_plan(K, B, sms):
    """The solve's launch plan for B scenarios of K samples, H = 50, on a
    card of ``sms`` SMs (None: off the card)."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=50)
    o = psolver._solve_options(cfg)
    return cuda_solve._plan(cfg, K, o["tile"], o["normalize"],
                            o["fuse_update"], B, sms)


@pytest.mark.parametrize("K,B,sms,branch", [
    (65536, 1, 132, True),      # 128 solve blocks leave 4 of 132 SMs
    (16384, 1, 132, True),
    (1024, 1, 132, False),      # the statistics cost less than a launch
    (128, 4096, 132, False),    # the fleet
    (65536, 1, 128, False),     # the solve's blocks fill every SM
    (65536, 1, 129, True),      # one SM left: one block of statistics
    (65536, 2, 132, False),     # 256 solve blocks: two waves
    (65536, 1, None, False)])   # off the card
def test_the_statistics_branch_rule(K, B, sms, branch):
    """``stats_branch``: the tail's statistics leave the control tail's
    launch above K = 1024, where the solve's blocks leave the SMs the
    statistics' one-block layout takes (one scenario, one block);
    elsewhere the fused tail stays."""
    plan = _solve_plan(K, B, sms)
    if K == 65536:
        assert (plan[1], plan[3]) == (128, 1)     # 128 tiles, one a block
    if B == 1:
        assert cuda_step.step_tail_layout(K, B, sms).group == 1
    assert cuda_step.stats_branch(K, B, sms, plan) is branch


def test_the_branch_layouts_fit_what_the_kernel_takes():
    """The statistics beside a solve stay in one block (no cluster), and
    the control alone has no statistics warps; both are layouts the
    kernel takes."""
    for K, B in ((65536, 1), (16384, 1), (65536, 2), (2000, 3)):
        lay = cuda_step.step_tail_layout(K, B, 132)
        assert lay.cluster == 1 and cuda_step.tail_layout_fits(lay, K)
        assert cuda_step.tail_layout_fits(cuda_step.CONTROL_LAYOUT, K)
    assert cuda_step.CONTROL_LAYOUT.warps == 0


def test_the_chunks_launches_name_the_statistics_launches(monkeypatch):
    """A chunk's key holds whether its statistics run on a branch, and its
    expected launches name ``cuda_step.STATS_LAUNCHES``: one a step on a
    branch, none in the fused tail; on a clustered tail layout a cluster
    tail a step in the fused tail, none on a branch, whose control tail
    runs in one block."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=16384, horizon=6)
    cpu, n = torch.device("cpu"), 16
    monkeypatch.setattr(cuda_step, "_tail_layout_on", lambda K, B, device:
                        cuda_step.step_tail_layout(K, B, 132, 15))
    for branch in (True, False):
        monkeypatch.setattr(ploop, "_branched",
                            lambda *a, branch=branch: branch)
        key, launches = ploop._chunk_key(ARM, cfg, SIM, 1, n, cpu, "cuda")
        assert key[-1][-1] is branch
        counts = dict(zip([name for _, name in cuda_graphs.COUNTERS],
                          launches))
        assert counts["STATS_LAUNCHES"] == (n if branch else 0)
        assert counts["TAIL_LAUNCHES"] == n
        assert counts["CLUSTER_TAILS"] == (0 if branch else n)
        assert (f"cuda_step.STATS_LAUNCHES {n}" in cuda_graphs.named(
            launches)) is branch


def _branch_run(monkeypatch, branch, steps, K=48, B=3):
    """``_step_loop`` (cuda backend, the plain versions on the CPU) with
    the statistics' branch forced on or off; returns its result and the
    calls of ``step_tail`` (its ``statistics``) and ``step_stats`` (its
    ``beside``)."""
    calls = {"tail": [], "stats": []}
    tail, stats = cuda_step.step_tail, cuda_step.step_stats

    def counted_tail(*a, **k):
        calls["tail"].append(k.get("statistics", True))
        return tail(*a, **k)

    def counted_stats(*a, **k):
        calls["stats"].append(k.get("beside", True))
        return stats(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "_branched", lambda *a, **k: branch)
        mp.setattr(cuda_step, "step_tail", counted_tail)
        mp.setattr(cuda_step, "step_stats", counted_stats)
        cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=6)
        ref = torch.as_tensor(P.synth_circle_path(40, revolutions=0.02),
                              dtype=torch.float32)
        states = P.init_sim_batch(cfg, SIM, np.arange(B), device="cpu")
        # scenarios that reach the path end near step 53, inside a chunk
        states = states._replace(mppi=states.mppi._replace(
            wp_idx=torch.tensor([0, 4, 8])))
        out = ploop._step_loop(ARM, cfg, SIM, ref, states, steps)
    return out, calls


def test_a_branched_chunk_records_the_fused_tails_bits(monkeypatch):
    """On the CPU (the plain versions) a loop whose chunks run the control
    tail and the statistics apart records the fused tail's bits, the
    frozen steps' zeroed statistics among them: a control tail and a
    statistics launch a step, the chunk's last statistics not beside a
    solve."""
    S = ploop._GRAPH_STEPS
    steps = 4 * S + 6
    (f1, r1), c1 = _branch_run(monkeypatch, True, steps)
    (f0, r0), c0 = _branch_run(monkeypatch, False, steps)
    assert bool(r0.done.any()) and not bool(r0.done[0].any())
    for name, a, b in zip(P.SimRecord._fields, r1, r0):
        assert torch.equal(a, b), name
    for a, b in zip(ploop._state_tensors(f1), ploop._state_tensors(f0)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert c0 == {"tail": [True] * steps, "stats": []}
    assert c1["tail"] == [False] * steps
    last = [i % S == S - 1 or i == steps - 1 for i in range(steps)]
    assert c1["stats"] == [not x for x in last]


def test_a_single_step_keeps_the_fused_tail(monkeypatch):
    """``sim_step`` has no chunk to overlap: its tail runs whole, with no
    statistics launch of its own, whatever the rule says."""
    calls = []
    tail = cuda_step.step_tail
    monkeypatch.setattr(ploop, "_branched", lambda *a, **k: True)
    monkeypatch.setattr(cuda_step, "stats_branch", lambda *a, **k: True)
    monkeypatch.setattr(cuda_step, "step_tail", lambda *a, **k: (
        calls.append(k.get("statistics", True)), tail(*a, **k))[1])
    monkeypatch.setattr(cuda_step, "step_stats", lambda *a, **k:
                        pytest.fail("a statistics launch in sim_step"))
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=32, horizon=6)
    ref = torch.as_tensor(P.synth_circle_path(500), dtype=torch.float32)
    state = P.init_sim(cfg, SIM, seed=3, device="cpu")
    ploop.sim_step(ARM, cfg, SIM, ref, state, backend="cuda")
    assert calls == [True]


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
    holds a logical lane's samples, in blocks of 1, 2 and 4 scenarios or
    on a cluster, that the kernel takes."""
    n = cuda_step.step_tail_threads(K)
    out = []
    for lanes, cap in sorted(cuda_step.TAIL_BUILT):
        for cluster in (1, 2, 4, 8):
            warps = -(-(n // 32) // (lanes * cluster))
            for group in (1, 2, 4):
                lay = cuda_step.TailLayout(warps, lanes, group, cap, cluster)
                if group <= B and cuda_step.tail_layout_fits(lay, K):
                    out.append(lay)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", [(1024, 1), (1024, 64), (128, 300),
                                 (100, 8), (30, 5), (4096, 3), (20000, 2),
                                 (65536, 1), (65536, 2)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("K", [4096, 20000, 65536])
def test_clustered_statistics_equal_the_twin_on_the_card(dev, K, B):
    """The clustered build's min, mean, ESS and entropy are the twin's bit
    for bit; the package takes it at 20000 and 65536 (at 4096 one block
    is faster)."""
    clustered = cuda_step.TailLayout(4, 1, 1, 64, 8)
    assert (cuda_step._tail_layout_on(K, B, dev) == clustered) is (K > 4096)
    args = _tail_inputs(K, B, dev, seed=K + 3 * B)
    before = cuda_step.CLUSTER_TAILS
    _, row = _run_tail(*args, layout=clustered)
    assert cuda_step.CLUSTER_TAILS == before + 1
    want = cuda_step.tail_stats_ordered(args[6], args[0].lam)
    fields = dict(zip(P.SimRecord._fields, row))
    for name, w in zip(("cost_min", "cost_mean", "ess", "weight_entropy"),
                       want):
        assert torch.equal(fields[name], w), name


def _chain(dev, K, steps, seed=5, layout=None, branch=None):
    """``simulate(backend="cuda")`` from ``init_sim(seed)`` at K samples,
    H = 50, on the 8000-point circle; the step tail in ``layout`` (None:
    the package's), its statistics on a branch or not as ``branch`` says
    (None: as the package's rule says), the chunks captured anew.  Returns
    the records and the tail launches and clustered tails it counted."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=50)
    ref = torch.as_tensor(P.synth_circle_path(8000), dtype=torch.float32,
                          device=dev)
    state = P.init_sim(cfg, SIM, seed=seed, device=dev)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "_GRAPHS", type(ploop._GRAPHS)())
        if layout is not None:
            mp.setattr(cuda_step, "_tail_layout_on", lambda *a: layout)
        if branch is not None:
            mp.setattr(ploop, "_branched", lambda *a, **k: branch)
        before = (cuda_step.TAIL_LAUNCHES, cuda_step.CLUSTER_TAILS)
        _, rec = P.simulate(ARM, cfg, SIM, ref, state, steps,
                            backend="cuda")
        torch.cuda.synchronize()
    return rec, (cuda_step.TAIL_LAUNCHES - before[0],
                 cuda_step.CLUSTER_TAILS - before[1])


@pytest.mark.cuda
def test_a_large_k_chain_records_the_one_block_layouts_bits(dev):
    """4000 steps at K = 65536 with the fused tail (the statistics off the
    branch): the tail on a cluster against the layout that reads S each
    pass in one block, every record field bit for bit."""
    K = 65536
    one_block = cuda_step.step_tail_layout(K, 1)
    assert one_block.cluster == 1 and one_block.cap == 0
    got, counts = _chain(dev, K, 4000, branch=False)
    want, _ = _chain(dev, K, 4000, layout=one_block, branch=False)
    assert counts == (4000, 4000)
    for name, a, b in zip(P.SimRecord._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cluster_tails_count_every_large_k_tail_and_no_k1024_one(dev):
    """Over a step-loop window of the fused tail ``CLUSTER_TAILS`` moves
    with ``TAIL_LAUNCHES`` at K = 65536 (replays adding what their
    captures recorded) and stays at K = 1024."""
    steps = 3 * ploop._GRAPH_STEPS + 5
    assert _chain(dev, 65536, steps, branch=False)[1] == (steps, steps)
    assert _chain(dev, 1024, steps)[1] == (steps, 0)



def _with_done(row, frozen):
    """A copy of the record ``row`` whose done lane is ``frozen``."""
    row = tuple(r.clone() for r in row)
    row[11].copy_(frozen)
    return row


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", [(16384, 1), (65536, 1), (65536, 2)])
def test_statistics_launch_equals_the_twin_on_the_card(dev, K, B):
    """``step_stats`` after the control tail: the control tail's row is the
    fused tail's but for the statistics lanes, and the statistics launch,
    beside a solve (one block) and alone (the tail's own layout, a
    cluster), writes the twin's bits (``tail_stats_ordered``), zeroed
    where the row's done lane is set."""
    args = _tail_inputs(K, B, dev, seed=K + B)
    cfg, ref, state, wp_new, path_end, u_seq, s, clock = args
    (*fused, fused_head), fused_row = _run_tail(*args)
    row = tuple(r[0] for r in ploop._row_buffers(
        1, ploop._as_state((*state[:5], None, state[5])), ref))
    *ctl, ctl_head = cuda_step.step_tail(
        ARM, cfg, SIM, ref, *state, wp_new, path_end, u_seq, s, clock, row,
        carry_head=True, statistics=False)
    torch.cuda.synchronize()
    for a, b in zip((*ctl, *ctl_head), (*fused[:7], *fused_head)):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(row, fused_row)):
        if not 7 <= i <= 10:
            assert torch.equal(a, b), P.SimRecord._fields[i]
    want = cuda_step.tail_stats_ordered(s, cfg.lam)
    frozen = torch.arange(B, device=dev) % 2 == 1
    for beside in (True, False):
        for done in (row[11], frozen):
            got = _with_done(row, done)
            before = (cuda_step.STATS_LAUNCHES, cuda_step.CLUSTER_TAILS)
            cuda_step.step_stats(cfg, s, got, beside=beside)
            torch.cuda.synchronize()
            assert (cuda_step.STATS_LAUNCHES - before[0],
                    cuda_step.CLUSTER_TAILS - before[1]) == (1, 0)
            for name, g, w in zip(P.SimRecord._fields[7:11], got[7:11],
                                  want):
                assert torch.equal(g, torch.where(done, 0.0, w)), name


def _loop(dev, K, B, steps, branch, captured):
    """``simulate_batch(backend="cuda")`` of B scenarios at K samples, H =
    50, on the 8000-point circle, the statistics on a branch or in the
    fused tail as ``branch`` says, as replayed graphs (chunks captured
    anew) or under ``cuda_graphs.uncaptured()``.  Returns the final state,
    the records and the tail and statistics launches it counted."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=50)
    ref = torch.as_tensor(P.synth_circle_path(8000), dtype=torch.float32,
                          device=dev)
    states = P.init_sim_batch(cfg, SIM, np.arange(B) + 11, device=dev)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "_GRAPHS", type(ploop._GRAPHS)())
        mp.setattr(ploop, "_branched", lambda *a, **k: branch)
        before = (cuda_step.TAIL_LAUNCHES, cuda_step.STATS_LAUNCHES)
        if captured:
            out = P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                   backend="cuda")
        else:
            with cuda_graphs.uncaptured():
                out = P.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                       backend="cuda")
        torch.cuda.synchronize()
    return (*out, (cuda_step.TAIL_LAUNCHES - before[0],
                   cuda_step.STATS_LAUNCHES - before[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", [(65536, 1), (65536, 2), (16384, 1)])
def test_a_branched_loop_records_the_fused_tails_bits(dev, K, B):
    """The loop with the statistics on a branch of each chunk against the
    fused tail's loop: every record field and the final state bit for
    bit, as replayed graphs and uncaptured; a statistics launch a tail
    over whole chunks on the branch, none in the fused tail.  The rule
    takes the branch at B = 1 on an H100 (132 SMs) and not at B = 2, whose
    solve fills the card; B = 2 forces it."""
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=50)
    if cuda_solve._sm_count(dev) == 132:
        assert ploop._branched(cfg, B, dev) is (B == 1)
    steps = 4 * ploop._GRAPH_STEPS + 5
    want = _loop(dev, K, B, steps, False, True)
    assert want[2] == (steps, 0)
    for captured in (True, False):
        got = _loop(dev, K, B, steps, True, captured)
        assert got[2] == (steps, steps), captured
        for name, a, b in zip(P.SimRecord._fields, got[1], want[1]):
            assert torch.equal(a, b), (name, captured)
        for a, b in zip(ploop._state_tensors(got[0]),
                        ploop._state_tensors(want[0])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
