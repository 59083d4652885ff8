"""The sample-sharded step's combine kernels (``ops/cuda_shard.py``) and the
cuda backend's step around them (``parallel/sharded.py``): the step head,
the solve kernel, MIN, ``shard_scale``, SUM, ``shard_finish``, the step
tail.

On the CPU, through the plain versions:
* ``shard_scale_plain`` and ``shard_finish_plain`` against the JAX
  package's own expressions of ``_solve_local_pallas``
  (``mppi_robotarm_tpu/parallel/sharded.py:139-152``, with its
  ``median_filter_reflect`` and ``shift_warm_start``) on the same NumPy
  inputs of two shards, in float64 and float32: the finish of JAX's own
  summed message bit for bit; each shard's message within 2 ulp relative
  (XLA's and torch's CPU ``exp`` round some arguments differently, by at
  most one ulp as measured, in float64 too), and u_seq end to end within
  4 ulp of the largest |Σwε| (measured: 1.9);
* ``make_sharded_sim_step(backend="cuda")`` on CPU tensors against
  :func:`parent_step`, a copy of the eager glue it replaced, bit for bit
  over 8 steps on a thread mesh of two shards, with scenarios at the path
  end, both noise modes, float32 and float64, filter windows 1, 10 and 2T
  + 3;
* stand-ins that count one head, rescale, finish and tail call a step and
  show that the cuda path calls none of the eager backend's pieces, and
  that CUDA tensors never take a plain version;
* ``tools/collective_cost.py`` at the tiny size over gloo in two
  processes: its JSON line's keys.

Marked ``cuda`` and skipped without a card: the two kernels against their
plain versions on the card, at the solve's real outputs (benchmark_preset,
K_local = 512, B = 1 and 64, both noise modes, filter windows 1, 10 and 2T
+ 3) bit for bit, float64 operands, and 8 sharded steps on the card (every
8th scenario frozen, four near the path end) against the same step through
the plain versions, bit for bit, one launch of each kernel a step.  The
file imports JAX inside a ``try``, so on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_shard_step.py -m cuda
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.models.arm import fk_ee
from mppi_robotarm_tpu_torch.mppi import solver as psolver
from mppi_robotarm_tpu_torch.ops import cuda_shard, cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.ops.waypoint import update_waypoint_index
from mppi_robotarm_tpu_torch.parallel import sharded as psh
from mppi_robotarm_tpu_torch.sim.loop import plant_step

from test_torch_parallel import run_mesh

try:                                     # the CPU parity tests' reference
    import jax
    import jax.numpy as jnp

    from mppi_robotarm_tpu.mppi.solver import shift_warm_start as jshift
    from mppi_robotarm_tpu.ops.filters import median_filter_reflect as jmed
except ImportError:                      # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM, SIM = P.ArmParams(), P.SimConfig()
F32, F64 = torch.float32, torch.float64
T_SMALL = 7
WINDOWS = (1, 2, 10, 2 * T_SMALL, 2 * T_SMALL + 3)
EXP_ULPS = 2        # a shard's message against JAX's: one exp's rounding
SEQ_ULPS = 4        # u_seq against JAX's, in ulp of the largest |Σwε|


def _partials(seed, B, T, lam, dtype, S=2):
    """S shards' (m_s, η_s, A_s) and u_prev from a NumPy seed: costs spread
    over a few λ, so that every shard's scale is neither 1 nor 0."""
    rng = np.random.default_rng(seed)
    m_s = rng.uniform(0.0, 3.0 * lam, size=(S, B))
    eta_s = rng.uniform(1.0, 40.0, size=(S, B))
    a_s = rng.normal(scale=20.0, size=(S, B, T, 2))
    u_prev = rng.normal(scale=5.0, size=(B, T, 2))
    return [v.astype(dtype) for v in (m_s, eta_s, a_s, u_prev)]


def _jax_combine(m_s, eta_s, a_s, u_prev, lam, fw):
    """JAX's :139-152 on S shards (the psums as a sum in shard order):
    (each shard's η·scale and A·scale, u_seq, u_next)."""
    m = jnp.min(jnp.asarray(m_s), axis=0)
    lam = jnp.asarray(lam, m.dtype)
    parts = []
    for s in range(m_s.shape[0]):
        scale = jnp.exp((m - jnp.asarray(m_s[s])) / lam)
        parts.append((jnp.asarray(eta_s[s]) * scale,
                      jnp.asarray(a_s[s]) * scale[:, None, None]))
    eta, a = parts[0]
    for e, x in parts[1:]:
        eta, a = eta + e, a + x
    w_eps = jax.vmap(lambda x: jmed(x, fw))(a / eta[:, None, None])
    u_seq = jnp.asarray(u_prev) + w_eps
    total = np.concatenate([np.asarray(eta)[:, None],
                            np.asarray(a).reshape(len(eta), -1)], axis=1)
    return ([(np.asarray(e), np.asarray(x)) for e, x in parts], total,
            np.asarray(u_seq), np.asarray(jax.vmap(jshift)(u_seq)))


def _port_combine(m_s, eta_s, a_s, u_prev, lam, cfg, dtype):
    """The plain versions on S shards: (each shard's message, u_seq)."""
    m_t = torch.as_tensor(m_s, dtype=dtype)
    m = m_t.amin(0)
    packs = [cuda_shard.shard_scale_plain(
        m, m_t[s], torch.as_tensor(eta_s[s], dtype=dtype),
        torch.as_tensor(a_s[s], dtype=dtype), lam) for s in range(len(m_s))]
    total = packs[0]
    for p in packs[1:]:
        total = total + p
    return packs, cuda_shard.shard_finish_plain(cfg, total, u_prev)


def needs_jax():
    if jax is None:
        pytest.skip("the CPU parity tests need the JAX package")


@pytest.mark.parametrize("fw", WINDOWS)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_versions_match_jax(fw, B, dtype):
    """The rescale and the finish against JAX's expressions.  The finish
    on JAX's own summed message is JAX's u_seq and shifted u_next bit for
    bit (a division, an exact selection, an add); each shard's message is
    within EXP_ULPS of JAX's, relative (XLA's and torch's CPU ``exp``
    round some arguments differently, in float64 too); end to end, u_seq
    is within SEQ_ULPS ulp of the largest |Σwε|."""
    needs_jax()
    lam = 7.0
    m_s, eta_s, a_s, u_prev = _partials(fw * 10 + B, B, T_SMALL, lam, dtype)
    jparts, jtotal, ju_seq, ju_next = _jax_combine(m_s, eta_s, a_s, u_prev,
                                                   lam, fw)
    tdt = F64 if dtype == np.float64 else F32
    cfg = dataclasses.replace(P.MPPIConfig(), horizon=T_SMALL,
                              filter_window=fw)
    u_prev_t = torch.as_tensor(u_prev, dtype=tdt)
    u_seq = cuda_shard.shard_finish_plain(
        cfg, torch.as_tensor(jtotal, dtype=tdt), u_prev_t)
    assert np.array_equal(u_seq.numpy(), ju_seq)
    assert np.array_equal(psolver.shift_warm_start(u_seq).numpy(), ju_next)
    ulp = float(np.finfo(dtype).eps)
    packs, u_seq = _port_combine(m_s, eta_s, a_s, u_prev_t, lam, cfg, tdt)
    for (je, ja), p in zip(jparts, packs):
        eta, a = cuda_shard.unpack(p)
        for got, want in ((eta, je), (a, ja)):
            np.testing.assert_allclose(got.numpy(), want, rtol=EXP_ULPS * ulp,
                                       atol=0)
    w_max = float(np.abs(ju_seq - u_prev).max())
    np.testing.assert_allclose(u_seq.numpy(), ju_seq, rtol=0,
                               atol=SEQ_ULPS * ulp * w_max)


def test_unpack_is_views_of_the_message():
    packed = torch.arange(2 * 7, dtype=F32).reshape(2, 7)
    eta, a = cuda_shard.unpack(packed)
    assert eta.tolist() == [0.0, 7.0]
    assert a.shape == (2, 3, 2) and a[1, 2, 1] == 13.0
    assert eta.data_ptr() == packed.data_ptr()


# ---- the step against the glue it replaced -----------------------------------

# The eager glue the step kernels replaced (``parallel/sharded.py``'s
# ``combine_partials``, ``_waypoints``, ``_finish``, ``_solve_cuda`` and the
# cuda backend of ``make_sharded_solve`` and ``step_fn``), copied: the
# yardstick.

def parent_combine_partials(m_loc, eta_loc, a_loc, lam, reduce):
    m = reduce(m_loc.clone(), "min")
    scale = torch.exp((m - m_loc) / lam)
    packed = torch.cat([(eta_loc * scale)[..., None],
                        (a_loc * scale[..., None, None]).flatten(-2)], dim=-1)
    packed = reduce(packed.contiguous(), "sum")
    return m, packed[..., 0], packed[..., 1:].unflatten(-1, a_loc.shape[-2:])


def parent_waypoints(cfg, ref_path, observed, wp_idx):
    x_obs, y_obs = fk_ee(observed[:, 0], observed[:, 1], cfg.l1, cfg.l2)
    wp_new, window, valid = update_waypoint_index(
        ref_path, wp_idx, x_obs, y_obs, cfg.search_idx_len, cfg.dist_scale)
    return wp_new, window, valid, wp_new >= ref_path.shape[0] - 1


def parent_finish(cfg, u_prev, w_eps, wp_new, path_end, s_local, w_local):
    u_seq = psolver._median_update(u_prev, w_eps, cfg)
    u_next = psolver.shift_warm_start(u_seq)
    return u_next[:, 0], u_seq, u_next, wp_new, path_end, s_local, w_local


def parent_solve_cuda(arm, cfg, ref_path, observed, u_prev, wp_idx, k_offset,
                      reduce, eps=None, seeds=None, step=None, k_local=None):
    f32, dtype = torch.float32, u_prev.dtype
    wp_new, window, _, path_end = parent_waypoints(cfg, ref_path, observed,
                                                   wp_idx)
    B, device = observed.shape[0], observed.device
    koff = torch.full((B,), k_offset, dtype=torch.int64, device=device)
    a_local, s_local, _, (m_loc, eta_loc) = cuda_solve.solve_batched(
        arm, cfg, observed.to(f32).contiguous(), u_prev.to(f32).contiguous(),
        window.to(f32).contiguous(), seed=seeds,
        eps=None if eps is None else eps.to(f32).contiguous(), step=step,
        emit_eps=False, normalize=False, fuse_update=False, k_local=k_local,
        k_offset=koff)
    m, eta, a = parent_combine_partials(m_loc, eta_loc, a_local, cfg.lam,
                                        reduce)
    w_local = (torch.exp(-(s_local - m[:, None]) / cfg.lam)
               / eta[:, None]).to(dtype)
    return parent_finish(cfg, u_prev, (a / eta[:, None, None]).to(dtype),
                         wp_new, path_end, s_local.to(dtype), w_local)


def parent_solve(arm, cfg, mesh, reduce):
    k_local, k_offset = psh._shard_samples(cfg, mesh)
    return lambda ref_path, observed, u_prev, wp_idx, eps: parent_solve_cuda(
        arm, cfg, ref_path, observed, u_prev, wp_idx, k_offset, reduce,
        eps=eps)


def parent_step(arm, cfg, sim, mesh, noise, reduce):
    k_local, k_offset = psh._shard_samples(cfg, mesh)

    def step_fn(ref_path, q, dq, u_prev, wp_idx, seeds=None, step=None,
                eps=None):
        observed = torch.cat([q, dq], dim=-1)
        B, device = q.shape[0], q.device
        if noise == "prng":
            col = lambda v: torch.as_tensor(
                v, dtype=torch.int64, device=device).reshape(-1).expand(B)
            seeds, step = col(seeds), col(step)
        out = parent_solve_cuda(arm, cfg, ref_path, observed, u_prev, wp_idx,
                                k_offset, reduce, eps=eps, seeds=seeds,
                                step=step, k_local=k_local)
        u0, _, u_next, wp_new, path_end, _, _ = out
        u0 = u0.to(q.dtype)
        q_new, dq_new = plant_step(arm, sim, q, dq, u0)
        keep = lambda new, old: torch.where(
            path_end.view(-1, *(1,) * (new.dim() - 1)), old, new)
        return (keep(q_new, q), keep(dq_new, dq),
                keep(u_next.to(u_prev.dtype), u_prev),
                torch.where(path_end, wp_idx, wp_new), path_end, u0)

    return step_fn


def _cfg(K=32, T=6, fw=10):
    return dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=T,
                               filter_window=fw, lam=50.0)


def _start(cfg, B, dtype, device="cpu", n_ref=60, seed=0):
    """A path of ``n_ref`` rows and B scenarios near its start, spread
    along it: every 8th at the last row (frozen at once), and near the
    end one (B < 8) or four (B >= 8) more."""
    ref = torch.as_tensor(P.synth_circle_path(n_ref), dtype=dtype,
                          device=device)
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(np.array([1.1522, -1.2661]) + 0.02 * rng.normal(
        size=(B, 2)), dtype=dtype, device=device)
    dq = torch.zeros((B, 2), dtype=dtype, device=device)
    u = torch.as_tensor(np.tile(cfg.warm_start, (B, cfg.horizon, 1)),
                        dtype=dtype, device=device)
    wp = torch.arange(B, dtype=torch.int64, device=device) * 3 % (n_ref - 4)
    wp[::8] = n_ref - 1
    near = [n_ref - 4, n_ref - 3, n_ref - 2, n_ref - 3] if B >= 8 else [
        n_ref - 3]
    wp[-len(near):] = torch.tensor(near, device=device)
    return ref, (q, dq, u, wp)


def _run_steps(make, cfg, B, dtype, noise, steps=8, device="cpu",
               n_ref=60):
    """``steps`` steps of ``make(mesh, reduce)``'s step on a thread mesh of
    two sample shards from :func:`_start`; returns each rank's outputs of
    every step."""
    ref, state = _start(cfg, B, dtype, device, n_ref)
    k_local = cfg.num_samples // 2
    rng = np.random.default_rng(5)
    eps = torch.as_tensor(rng.normal(size=(steps, B, cfg.num_samples,
                                           cfg.horizon, 2)) * np.sqrt(20.0),
                          dtype=dtype, device=device)

    def body(m, reduce):
        f = make(m, reduce)
        s = m.coord[1]
        st, outs = state, []
        for i in range(steps):
            kw = (dict(eps=eps[i][:, s * k_local:(s + 1) * k_local])
                  if noise == "eps" else
                  dict(seeds=torch.arange(B, device=device) + 11,
                       step=torch.full((B,), i, device=device)))
            out = f(ref, *st, **kw)
            outs.append(out)
            st = out[:4]
        return outs

    return run_mesh((1, 2), body)[0]


@pytest.mark.parametrize("fw", [1, 10, 15])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_cuda_step_equals_the_parent_glue(noise, dtype, fw):
    """The restructured cuda backend on CPU tensors (the plain versions of
    the head, rescale, finish and tail) equals the glue it replaced, bit
    for bit over 8 steps, every output of every step on both shards."""
    cfg = _cfg(fw=fw)
    new = _run_steps(lambda m, r: psh.make_sharded_sim_step(
        ARM, cfg, SIM, m, backend="cuda", noise=noise, reduce=r),
        cfg, 4, dtype, noise)
    old = _run_steps(lambda m, r: parent_step(ARM, cfg, SIM, m, noise, r),
                     cfg, 4, dtype, noise)
    for s in range(2):
        for i, (a, b) in enumerate(zip(new[s], old[s])):
            for name, x, y in zip(("q", "dq", "u_prev", "wp_idx", "done",
                                   "u0"), a, b):
                assert x.dtype == y.dtype, (s, i, name)
                assert torch.equal(x, y), (s, i, name)
    assert bool(new[0][-1][4][0]) and not bool(new[0][-1][4][1])


@pytest.mark.parametrize("fw", [1, 10, 15])
def test_cuda_solve_equals_the_parent_glue(fw):
    """``make_sharded_solve(backend="cuda")`` on CPU tensors: its seven
    outputs equal the parent's glue, bit for bit, on both shards."""
    cfg = _cfg(K=64, fw=fw)
    B = 3
    ref, (q, dq, u, wp) = _start(cfg, B, F32)
    obs = torch.cat([q, dq], dim=-1)
    eps = torch.as_tensor(np.random.default_rng(2).normal(
        size=(B, 32, cfg.horizon, 2)) * np.sqrt(20.0), dtype=F32)
    outs = [run_mesh((1, 2), lambda m, r: make(ARM, cfg, m, r)(
        ref, obs, u, wp, eps))[0] for make in (
        lambda a, c, m, r: psh.make_sharded_solve(a, c, m, backend="cuda",
                                                  reduce=r),
        parent_solve)]
    for s in range(2):
        for name, x, y in zip(("u0", "u_seq", "u_next", "wp_idx", "path_end",
                               "S", "w"), outs[0][s], outs[1][s]):
            assert x.dtype == y.dtype and torch.equal(x, y), (s, name)


# ---- stand-ins: what a step calls --------------------------------------------

def _count(monkeypatch, module, names, calls, fail=()):
    """Wrap ``module``'s functions ``names`` to count their calls into
    ``calls``; make ``fail``'s fail the test."""
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, name, counted)
    for name in fail:
        monkeypatch.setattr(module, name, lambda *a, _n=name, **k:
                            pytest.fail(f"{_n} called"))


@pytest.mark.parametrize("plain", [False, True])
def test_a_step_calls_each_step_kernel_once(monkeypatch, plain):
    """One head, rescale, finish and tail call a step on each rank (the
    wrappers, or with ``plain`` their plain versions and never a wrapper),
    and none of the eager backend's waypoint advance, median update, plant
    or freeze."""
    wrappers = (("step_head", "step_tail"), ("shard_scale", "shard_finish"))
    plains = (("step_head_plain", "step_tail_plain"),
              ("shard_scale_plain", "shard_finish_plain"))
    calls = {}
    for mod, names, other in zip((cuda_step, cuda_shard),
                                 plains if plain else wrappers,
                                 wrappers if plain else ((), ())):
        _count(monkeypatch, mod, names, calls, fail=other)
    for name in ("_waypoints", "_finish", "_median_update", "plant_step",
                 "update_waypoint_index", "fk_ee"):
        monkeypatch.setattr(psh, name, lambda *a, _n=name, **k:
                            pytest.fail(f"sharded.{_n} called"))
    cfg = _cfg()
    _run_steps(lambda m, r: psh.make_sharded_sim_step(
        ARM, cfg, SIM, m, backend="cuda", noise="prng", reduce=r,
        plain=plain), cfg, 3, F32, "prng", steps=8)
    assert calls == {name: 2 * 8 for pair in (plains if plain else wrappers)
                     for name in pair}


def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrappers dispatch on where the tensors lie: all on the CPU takes
    the plain version, anything elsewhere the kernel (here a stand-in that
    records the call), never the plain version."""
    calls = []
    monkeypatch.setattr(cuda_shard, "_scale_launch",
                        lambda *a: calls.append("scale"))
    monkeypatch.setattr(cuda_shard, "_finish_launch",
                        lambda *a: calls.append("finish"))
    for name in ("shard_scale_plain", "shard_finish_plain"):
        monkeypatch.setattr(cuda_shard, name, lambda *a, _n=name:
                            pytest.fail(f"{_n} on the card"))
    cfg = _cfg(T=4)
    meta = torch.empty((2, 9), device="meta")    # a tensor elsewhere
    m = torch.zeros(2)
    cuda_shard.shard_scale(m, m, meta[:, 0], torch.zeros(2, 4, 2), 1.0)
    cuda_shard.shard_finish(cfg, meta, torch.zeros(2, 4, 2))
    assert calls == ["scale", "finish"]


@pytest.mark.parametrize("case", ["a_last", "eta", "m_shape", "strided",
                                  "int", "packed", "horizon"])
def test_the_launchers_refuse_operands_they_do_not_take(case):
    """The launchers check every operand before they load the library:
    shapes, dtypes, contiguity and the horizon (on meta tensors, which
    reach no kernel)."""
    d = dict(device="meta")
    m, eta, a = (torch.empty(3, **d), torch.empty(3, **d),
                 torch.empty(3, 5, 2, **d))
    if case in ("a_last", "eta", "m_shape", "strided", "int"):
        args = {"a_last": (m, m, eta, torch.empty(3, 5, 3, **d)),
                "eta": (m, m, torch.empty(4, **d), a),
                "m_shape": (torch.empty(3, 1, **d), m, eta, a),
                "strided": (m, m, eta,
                            torch.empty(3, 2, 5, **d).transpose(1, 2)),
                "int": (m, m, torch.empty(3, dtype=torch.int64, **d),
                        a)}[case]
        with pytest.raises((ValueError, TypeError)):
            cuda_shard._scale_launch(*args, 1.0)
        return
    cfg = _cfg(T=5)
    if case == "horizon":
        cfg = dataclasses.replace(cfg, horizon=cuda_shard.MAX_HORIZON + 1)
        a = torch.empty(3, cfg.horizon, 2, **d)
    with pytest.raises((ValueError, TypeError)):
        cuda_shard._finish_launch(cfg, torch.empty(3, 10, **d), a)


# ---- tools/collective_cost.py -------------------------------------------------

def test_collective_cost_runs_two_ranks_over_gloo(tmp_path):
    """The tool at the tiny size on the CPU, two rank processes over gloo:
    one JSON line with its keys, a row for each program and rank with
    every statistic, and the package the ranks ran."""
    r = subprocess.run(
        [sys.executable, "-m", "mppi_robotarm_tpu_torch.tools.collective_cost",
         "--device", "cpu", "--size", "tiny", "--pairs", "3", "--chain", "2",
         "--label", "test", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line) == {"tool", "label", "card", "package", "mesh", "B",
                         "K", "K_local", "T", "payload_bytes_per_solve",
                         "pairs", "chain", "rows", "events_per_step",
                         "device_us_per_step"}
    assert line["card"] == "cpu" and line["label"] == "test"
    assert line["mesh"] == [1, 2] and line["K_local"] == line["K"] // 2
    assert line["payload_bytes_per_solve"] == 4 * line["B"] * (
        2 + 2 * line["T"])
    assert os.path.samefile(line["package"],
                            os.path.join(REPO, "mppi_robotarm_tpu_torch"))
    assert sorted((row["program"], row["rank"]) for row in line["rows"]) == [
        ("solve", 0), ("solve", 1), ("step", 0), ("step", 1)]
    for row in line["rows"]:
        assert row["us_with"] > 0 and row["us_without"] > 0
        q1, q3 = row["iqr_us"]
        assert q1 <= row["collective_cost_us_median"] <= q3
        assert row["resolved"] == (q1 > 0 or q3 < 0)
        assert (row["upper_bound_us"] is None) == row["resolved"]
    # the profile is the card's; the CPU has none
    assert line["events_per_step"] == [None, None]


def test_paired_statistics():
    from mppi_robotarm_tpu_torch.tools.collective_cost import paired

    s = paired([3e-6, 4e-6, 5e-6, 6e-6], [1e-6, 1e-6, 1e-6, 1e-6])
    assert s["resolved"] and s["upper_bound_us"] is None
    assert s["collective_cost_us_median"] == pytest.approx(3.5)
    s = paired([1e-6, 3e-6, 1e-6, 3e-6], [2e-6, 2e-6, 2e-6, 2e-6])
    assert not s["resolved"] and s["upper_bound_us"] == pytest.approx(1.0)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shard kernels run on the card")
    return torch.device("cuda", 0)


def _k2_partials(dev, B, noise, fw, seed=0):
    """Two shards' solve-kernel partials at benchmark_preset (K_local =
    512) on card tensors, stacked (2, B, ...), and u_prev; the config."""
    arm, cfg, _ = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, filter_window=fw)
    T, kl = cfg.horizon, cfg.num_samples // 2
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor((np.array([1.1522, -1.2661, 0.1, -0.2]) + rng.normal(
        scale=0.01, size=(B, 4))).astype(np.float32), device=dev)
    u = torch.as_tensor((np.array([10.0, -2.0]) + rng.normal(
        size=(B, T, 2))).astype(np.float32), device=dev)
    ref = torch.as_tensor(P.synth_circle_path(2000), device=dev)
    starts = 11 * torch.arange(B, device=dev) % 1900
    win = ref[starts[:, None] + torch.arange(cfg.search_idx_len,
                                             device=dev)].contiguous()
    eps = torch.as_tensor((rng.normal(size=(B, 2 * kl, T, 2)) * np.sqrt(
        20.0)).astype(np.float32), device=dev)
    parts = [cuda_solve.solve_batched(
        arm, cfg, x0, u, win, emit_eps=False, normalize=False, k_local=kl,
        k_offset=torch.full((B,), r * kl, device=dev),
        **(dict(eps=eps[:, r * kl:(r + 1) * kl].contiguous())
           if noise == "eps" else
           dict(seed=torch.arange(B, device=dev) + 5,
                step=torch.full((B,), 7, device=dev))))
        for r in range(2)]
    stack = lambda i, j=None: torch.stack(
        [p[i] if j is None else p[i][j] for p in parts])
    return cfg, stack(3, 0), stack(3, 1), stack(0), u


@pytest.mark.cuda
@pytest.mark.parametrize("fw", [1, 10, 103])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_shard_kernels_equal_their_plain_versions(dev, noise, B, fw):
    """S3 and S4 against their plain versions on the same card tensors, at
    the solve kernel's real partials: the two shards' messages (stacked,
    one launch) and the finish of their sum, bit for bit."""
    cfg, m_s, eta_s, a_s, u = _k2_partials(dev, B, noise, fw)
    m = m_s.amin(0, keepdim=True).expand_as(m_s).contiguous()
    got = cuda_shard.shard_scale(m, m_s, eta_s, a_s, cfg.lam)
    want = cuda_shard.shard_scale_plain(m, m_s, eta_s, a_s, cfg.lam)
    assert torch.equal(got, want)
    total = want.sum(0)
    got_u = cuda_shard.shard_finish(cfg, total, u)
    want_u = cuda_shard.shard_finish_plain(cfg, total, u)
    torch.cuda.synchronize()
    assert torch.equal(got_u, want_u)
    assert bool(torch.isfinite(got_u).all())


@pytest.mark.cuda
def test_shard_kernels_take_float64(dev):
    """Float64 operands run in float32 and come back cast: the float32
    run's bits."""
    cfg, m_s, eta_s, a_s, u = _k2_partials(dev, 8, "eps", 10)
    m = m_s.amin(0, keepdim=True).expand_as(m_s).contiguous()
    p32 = cuda_shard.shard_scale(m, m_s, eta_s, a_s, cfg.lam)
    p64 = cuda_shard.shard_scale(m.double(), m_s.double(), eta_s.double(),
                                 a_s.double(), cfg.lam)
    assert p64.dtype == F64 and torch.equal(p64, p32.double())
    total = p32.sum(0)          # a shard's own message may hold η = 0
    u32 = cuda_shard.shard_finish(cfg, total, u)
    u64 = cuda_shard.shard_finish(cfg, total.double(), u.double())
    assert u64.dtype == F64 and torch.equal(u64, u32.double())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["eps", "prng"])
def test_sharded_step_on_the_card_equals_the_plain_step(dev, noise):
    """8 sharded steps on the card (a thread a shard, benchmark_preset's
    K = 1024 cut in two; B = 16 on a 200-row path, every 8th scenario at
    the last row, four near it) with the step kernels against the same
    step through their plain versions: every output bit for bit, and one
    launch of each kernel a step a rank."""
    arm, cfg, sim = P.benchmark_preset()
    B = 16
    counts = lambda: (cuda_step.HEAD_LAUNCHES, cuda_shard.SCALE_LAUNCHES,
                      cuda_shard.FINISH_LAUNCHES, cuda_step.TAIL_LAUNCHES,
                      cuda_solve.LAUNCHES)

    def run(plain):
        return _run_steps(lambda m, r: psh.make_sharded_sim_step(
            arm, cfg, sim, m, backend="cuda", noise=noise, reduce=r,
            plain=plain), cfg, B, F32, noise, device=dev, n_ref=200)

    before = counts()
    got = run(False)
    torch.cuda.synchronize()
    after = counts()
    assert [b - a for a, b in zip(before, after)] == [2 * 8] * 5
    want = run(True)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(after, counts())] == [0] * 4 + [2 * 8]
    for s in range(2):
        for a, b in zip(got[s], want[s]):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
