"""The whole closed loop in one launch: wrapper, CUDA kernel, plain twin.

``fused_sim_run_batched`` runs ``n_steps`` closed-loop steps of B scenarios
(waypoint advance and freeze, noise, K×T rollout and cost, softmax and
stats, Σwε, reflect median, control update and shift, plant step, record
row) and returns ``(records (B, n_steps, 12) f32, u_final (B, T, 2) f32)``.
It is the port of ``mppi_robotarm_tpu/ops/pallas_sim.py::
pallas_sim_run_batched`` and its two kernels: ``_sim_kernel`` and, for
``1 < group <= 8`` at K <= 128, the scenario-fleet kernel
``_sim_kernel_stacked``.

The path is picked by where the tensors lie: CUDA tensors launch a
hand-written kernel (built by ``ops/_build.py`` and bound through
``ctypes``) or raise — ``csrc/fleet_kernel.cu`` (one warp per scenario)
for ``1 < group <= 8`` at K <= 128, ``csrc/sim_kernel.cu`` (a cluster of
:func:`cluster_size` blocks per scenario) otherwise; the two, and every
cluster size, give the same bits per scenario.  CPU tensors
take the plain PyTorch versions of the same function,
:func:`fused_sim_reference_stacked` for ``group > 1`` and
:func:`fused_sim_reference` otherwise.  Nothing falls back from one to the
other.

Noise: with ``eps`` (B, n_steps, K, T, 2) the kernel reads the caller's
noise (the parity seam); without it, each step draws Philox4x32-10 normals
keyed (seed, step0 + step) with counter (k, t, 0, 0), so a chained run
continues the stream of one long run bit for bit.

Record lanes: [q1, q2, dq1, dq2, u1, u2, wp_idx, done, cost_min, cost_mean,
ess, weight_entropy].  A frozen (path-end) step keeps its state, records
done=1 and zeroes the u and cost lanes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import ArmParams, MPPIConfig, SimConfig
from .cuda_rollout import (
    _f32,
    chol_terms,
    dynamics_step,
    philox_epsilon,
    philox_epsilon_batch,
    rollout_cost_trig,
)
from .filters import median_filter_reflect
from .noise import sigma_inverse

REC_LANES = 12
MAX_SAMPLES = 8192        # K ≤ 8 samples per thread of a 1024-thread block
FLEET_MAX_SAMPLES = 128   # fleet kernel: K ≤ 4 slots of 32 samples
FLEET_MAX_GROUP = 8       # fleet kernel: scenarios per block (group)
FLEET_MAX_WARPS = 8       # fleet kernel: warps per block
CLUSTER_SIZES = (8, 4, 2, 1)   # sim_kernel: blocks per scenario
CTA_MIN_WARPS = 4         # cluster_size: one warp per scheduler of an SM

# The window width csrc/mppi_device.cuh compiles the one-chain window scan
# at (kScanWidth), beside the loop over a width read at run time: the
# reference's search_idx_len, which every configuration runs.
SCAN_WIDTH = 30

# Kernel launches made by fused_sim_run_batched, of sim_kernel (LAUNCHES)
# and of fleet_kernel (FLEET_LAUNCHES, of which FLEET_COMPILED_SCANS
# scanned the window at its compiled width, :func:`scan_width`); a run
# that must show it went through a kernel reads them before and after.
LAUNCHES = 0
FLEET_LAUNCHES = 0
FLEET_COMPILED_SCANS = 0

_ARM_FIELDS = ("a11", "b11", "c11", "m2", "l2", "k12", "k12b", "m22", "g1a",
               "g1b", "lc2", "l1", "g2")


class _ArmConsts(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in _ARM_FIELDS]


class _SimParams(ctypes.Structure):
    """Mirror of ``SimParams`` in csrc/sim_common.cuh, field for field."""

    _fields_ = [
        ("arm", _ArmConsts),
        ("l1c", ctypes.c_float), ("l2c", ctypes.c_float),
        ("lam", ctypes.c_float), ("gamma", ctypes.c_float),
        ("dt_c", ctypes.c_float), ("dt_p", ctypes.c_float),
        ("cost_scale", ctypes.c_float), ("dist_scale", ctypes.c_float),
        ("stage_w", ctypes.c_float * 4), ("term_w", ctypes.c_float * 4),
        ("exploit_thresh", ctypes.c_float), ("u_clamp", ctypes.c_float),
        ("dist1", ctypes.c_float), ("dist2", ctypes.c_float),
        ("l11", ctypes.c_float), ("l21", ctypes.c_float),
        ("l22", ctypes.c_float),
        ("sinv", ctypes.c_float * 4),
        ("k_actual", ctypes.c_float),
        ("has_clamp", ctypes.c_int),
        ("K", ctypes.c_int), ("T", ctypes.c_int), ("W", ctypes.c_int),
        ("fw", ctypes.c_int),
        ("n_ref", ctypes.c_int), ("n_steps", ctypes.c_int),
        ("use_prng", ctypes.c_int),
    ]


def _arm_consts(p: ArmParams) -> _ArmConsts:
    """The arm's constant sub-products, grouped as Python evaluates them in
    :func:`~.cuda_rollout.dynamics_step_trig` (float64, then float32)."""
    return _ArmConsts(
        a11=p.m1 * p.lc1 ** 2 + p.l1, b11=p.l1 ** 2 + p.lc2 ** 2,
        c11=2.0 * p.l1 * p.lc2, m2=p.m2, l2=p.l2, k12=p.m2 * p.l1 * p.lc2,
        k12b=p.m2 * p.lc2 ** 2, m22=p.m2 * p.lc2 ** 2 + p.l2,
        g1a=p.m1 * p.lc1 * p.g, g1b=p.m2 * p.g, lc2=p.lc2, l1=p.l1,
        g2=p.m2 * p.lc2 * p.g)


def _sim_params(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig, n_ref: int,
                n_steps: int, use_prng: bool) -> _SimParams:
    f4 = ctypes.c_float * 4
    l11, l21, l22 = chol_terms(cfg.sigma)
    return _SimParams(
        arm=_arm_consts(arm), l1c=cfg.l1, l2c=cfg.l2, lam=cfg.lam,
        gamma=cfg.gamma, dt_c=cfg.delta_t, dt_p=sim.dt,
        cost_scale=cfg.cost_scale, dist_scale=cfg.dist_scale,
        stage_w=f4(*cfg.stage_cost_weight),
        term_w=f4(*cfg.terminal_cost_weight),
        exploit_thresh=(1.0 - cfg.exploration) * cfg.num_samples,
        u_clamp=0.0 if cfg.u_clamp is None else cfg.u_clamp,
        dist1=sim.disturbance[0], dist2=sim.disturbance[1],
        l11=l11, l21=l21, l22=l22,
        sinv=f4(*sigma_inverse(cfg.sigma).reshape(4)),
        k_actual=cfg.num_samples, has_clamp=cfg.u_clamp is not None,
        K=cfg.num_samples, T=cfg.horizon, W=cfg.search_idx_len,
        fw=cfg.filter_window, n_ref=n_ref, n_steps=n_steps,
        use_prng=use_prng)


def _reference_one(arm, cfg, sim, ref, q, dq, u, wp, seed: int, step0: int,
                   n_steps: int, eps):
    """One scenario of :func:`fused_sim_reference` (tensors on one device)."""
    K, W = cfg.num_samples, cfg.search_idx_len
    device = ref.device
    f32 = torch.float32
    n = ref.shape[0]
    exploit = (torch.arange(K, device=device).to(f32)
               < _f32((1.0 - cfg.exploration) * cfg.num_samples))
    offs = torch.arange(W, device=device)
    zero = torch.zeros((), dtype=f32, device=device)

    q1, q2, dq1, dq2 = q[0], q[1], dq[0], dq[1]
    done = torch.zeros((), dtype=torch.bool, device=device)
    rows = []
    for step in range(n_steps):
        # ---- waypoint advance and freeze (_wp_advance_scalar) ----------
        x = cfg.l1 * torch.cos(q1) + cfg.l2 * torch.cos(q1 + q2)
        y = cfg.l1 * torch.sin(q1) + cfg.l2 * torch.sin(q1 + q2)
        idx0 = wp + offs
        win0 = ref[torch.clamp(idx0, max=n - 1)]
        dx = x - win0[:, 0]
        dy = y - win0[:, 1]
        d = (dx * dx + dy * dy) * cfg.dist_scale
        d = torch.where(idx0 < n, d, torch.inf)
        wn = wp + torch.argmin(d)
        frz = done | (wn >= n - 1)
        wp = torch.where(frz, wp, wn)
        done = frz
        win = ref[torch.clamp(wp + offs, max=n - 1)]

        # ---- noise ------------------------------------------------------
        eps_t = (philox_epsilon(seed, step0 + step, cfg, device)
                 if eps is None else eps[step])

        # ---- rollout and cost, vectorised over K (trig carry) -----------
        s = rollout_cost_trig(arm, cfg, q1, q2, dq1, dq2, u, eps_t, win,
                              exploit)

        # ---- softmax and stats ------------------------------------------
        m = torch.amin(s)
        e = torch.exp(-(s - m) / cfg.lam)
        eta = torch.sum(e)
        inv_eta = 1.0 / eta
        stats = (m, torch.sum(s) / _f32(K), (eta * eta) / torch.sum(e * e),
                 torch.log(eta) + torch.sum(e * (s - m)) * inv_eta / cfg.lam)

        # ---- Σwε, median, u update and warm-start shift (Q3) -------------
        weps = torch.sum(e[:, None, None] * eps_t, dim=0) * inv_eta
        unew = u + median_filter_reflect(weps, cfg.filter_window)
        u = torch.where(frz, u, torch.cat([unew[1:], unew[-1:]], dim=0))

        # ---- plant step at sim dt and record row (_plant_record_scalar) --
        u1, u2 = u[0, 0], u[0, 1]
        nq = dynamics_step(q1, q2, dq1, dq2, u1 + sim.disturbance[0],
                           u2 + sim.disturbance[1], sim.dt, arm)
        q1, q2, dq1, dq2 = (torch.where(frz, old, new) for old, new
                            in zip((q1, q2, dq1, dq2), nq))
        rows.append(torch.stack(
            [q1, q2, dq1, dq2, torch.where(frz, zero, u1),
             torch.where(frz, zero, u2), wp.to(f32), frz.to(f32)]
            + [torch.where(frz, zero, v) for v in stats]))
    rec = (torch.stack(rows) if rows
           else torch.empty((0, REC_LANES), dtype=f32, device=device))
    return rec, u


def fused_sim_reference(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                        ref_path, q0, dq0, u_prev, wp_idx, seed, n_steps,
                        eps=None, step0=None):
    """Plain PyTorch version of the fused closed-loop kernel.

    Same arguments and results as :func:`fused_sim_run_batched`, on any
    device: vectorised over K, Python loops over scenarios, steps and T,
    and the kernel's arithmetic — the trig carry, the exact metric, the
    JAX kernel's entropy form, the same Philox stream.  Only the order of
    the K-sums differs from the kernel.
    """
    _check_config(cfg)
    B = q0.shape[0]
    if step0 is None:
        step0 = torch.zeros(B, dtype=torch.int64)
    seeds = [int(v) for v in torch.as_tensor(seed).reshape(B).tolist()]
    steps0 = [int(v) for v in torch.as_tensor(step0).reshape(B).tolist()]
    wp = torch.as_tensor(wp_idx, device=ref_path.device).reshape(B).long()
    recs, ufins = [], []
    for b in range(B):
        rec, ufin = _reference_one(
            arm, cfg, sim, ref_path, q0[b], dq0[b], u_prev[b], wp[b],
            seeds[b], steps0[b], n_steps, None if eps is None else eps[b])
        recs.append(rec)
        ufins.append(ufin)
    return torch.stack(recs), torch.stack(ufins)


def fused_sim_reference_stacked(arm: ArmParams, cfg: MPPIConfig,
                                sim: SimConfig, ref_path, q0, dq0, u_prev,
                                wp_idx, seed, n_steps, eps=None, step0=None):
    """Plain PyTorch version of the fleet kernel: :func:`fused_sim_reference`
    with the B scenarios as a tensor dimension instead of a Python loop.

    The counterpart of ``_sim_kernel_stacked``'s layout, in which the
    scenarios ride the sublanes.  Every operation is the per-scenario one
    batched over B, so each scenario's results equal
    :func:`fused_sim_reference`'s.
    """
    _check_config(cfg)
    B, K, W = q0.shape[0], cfg.num_samples, cfg.search_idx_len
    device = ref_path.device
    f32 = torch.float32
    n = ref_path.shape[0]
    col = lambda v: torch.as_tensor(v, device=device).reshape(B).long()
    seeds = col(seed)
    steps0 = (torch.zeros(B, dtype=torch.int64, device=device)
              if step0 is None else col(step0))
    wp = col(wp_idx)
    exploit = (torch.arange(K, device=device).to(f32)
               < _f32((1.0 - cfg.exploration) * cfg.num_samples)
               ).expand(B, K)
    offs = torch.arange(W, device=device)
    zero = torch.zeros((), dtype=f32, device=device)
    no_offset = torch.zeros(B, dtype=torch.int64, device=device)

    q1, q2, dq1, dq2 = q0[:, 0], q0[:, 1], dq0[:, 0], dq0[:, 1]
    u = u_prev
    done = torch.zeros(B, dtype=torch.bool, device=device)
    rows = []
    for step in range(n_steps):
        # ---- waypoint advance and freeze, per scenario ------------------
        x = cfg.l1 * torch.cos(q1) + cfg.l2 * torch.cos(q1 + q2)
        y = cfg.l1 * torch.sin(q1) + cfg.l2 * torch.sin(q1 + q2)
        idx0 = wp[:, None] + offs
        win0 = ref_path[torch.clamp(idx0, max=n - 1)]
        dx = x[:, None] - win0[..., 0]
        dy = y[:, None] - win0[..., 1]
        d = (dx * dx + dy * dy) * cfg.dist_scale
        d = torch.where(idx0 < n, d, torch.inf)
        wn = wp + torch.argmin(d, dim=1)
        frz = done | (wn >= n - 1)
        wp = torch.where(frz, wp, wn)
        done = frz
        win = ref_path[torch.clamp(wp[:, None] + offs, max=n - 1)]

        # ---- noise ------------------------------------------------------
        eps_t = (philox_epsilon_batch(seeds, steps0 + step, no_offset, K,
                                      cfg)
                 if eps is None else eps[:, step])

        # ---- rollout and cost, (B, K) ------------------------------------
        s = rollout_cost_trig(arm, cfg, q1[:, None], q2[:, None],
                              dq1[:, None], dq2[:, None], u, eps_t,
                              win[:, None], exploit)

        # ---- softmax and stats ------------------------------------------
        m = torch.amin(s, dim=1)
        e = torch.exp(-(s - m[:, None]) / cfg.lam)
        eta = torch.sum(e, dim=1)
        inv_eta = 1.0 / eta
        stats = (m, torch.sum(s, dim=1) / _f32(K),
                 (eta * eta) / torch.sum(e * e, dim=1),
                 torch.log(eta)
                 + torch.sum(e * (s - m[:, None]), dim=1) * inv_eta / cfg.lam)

        # ---- Σwε, median, u update and warm-start shift (Q3) -------------
        weps = torch.sum(e[:, :, None, None] * eps_t, dim=1) \
            * inv_eta[:, None, None]
        med = median_filter_reflect(weps.movedim(1, 0), cfg.filter_window)
        unew = u + med.movedim(0, 1)
        u = torch.where(frz[:, None, None], u,
                        torch.cat([unew[:, 1:], unew[:, -1:]], dim=1))

        # ---- plant step at sim dt and record row -------------------------
        u1, u2 = u[:, 0, 0], u[:, 0, 1]
        nq = dynamics_step(q1, q2, dq1, dq2, u1 + sim.disturbance[0],
                           u2 + sim.disturbance[1], sim.dt, arm)
        q1, q2, dq1, dq2 = (torch.where(frz, old, new) for old, new
                            in zip((q1, q2, dq1, dq2), nq))
        rows.append(torch.stack(
            [q1, q2, dq1, dq2, torch.where(frz, zero, u1),
             torch.where(frz, zero, u2), wp.to(f32), frz.to(f32)]
            + [torch.where(frz, zero, v) for v in stats], dim=1))
    rec = (torch.stack(rows, dim=1) if rows
           else torch.empty((B, 0, REC_LANES), dtype=f32, device=device))
    return rec, u


def sim_threads(num_samples: int) -> int:
    """sim_kernel's virtual block: min(1024, round_up(K, 32)) threads, one
    per sample (each thread takes every nthr-th sample beyond)."""
    return min(1024, -(-num_samples // 32) * 32)


def cluster_size(batch: int, num_samples: int, sm_count: int) -> int:
    """Blocks per scenario for sim_kernel: the largest C in
    :data:`CLUSTER_SIZES` that splits the virtual block into whole warps
    (C divides nthr / 32), leaves each block at least
    :data:`CTA_MIN_WARPS` warps and keeps batch × C within the card's
    ``sm_count`` streaming multiprocessors; else 1.  A pure function of the
    shape: a large fleet keeps one block per scenario.

    Each sample's rollout is a dependent chain, so once every scheduler of
    an SM holds one warp, more SMs cannot shorten the step and the cluster
    barriers only add to it: on an H100 at ``benchmark_preset`` C=8 (four
    warps a block) beat C=16 (a non-portable size, no longer offered), and
    at K=100 C=1 beat C=2 and C=4 (PERF.md).
    """
    nwarp = sim_threads(num_samples) // 32
    return next(c for c in CLUSTER_SIZES
                if nwarp % c == 0 and nwarp >= CTA_MIN_WARPS * c
                and batch * c <= sm_count or c == 1)


def scan_width(window: int, lanes: int = 1) -> int:
    """The compiled width the issue-bound kernels scan a window of
    ``window`` rows at, ``lanes`` threads a sample: the window where the
    library holds the one-chain scan compiled at it (:data:`SCAN_WIDTH`)
    and one lane scans a sample alone (fleet_kernel, and solve_kernel at
    one lane a sample), else 0, the loop over a width read at run time.
    The lanes that split a scan (solve_kernel at 2 and 4) and sim_kernel's
    two-chain scan are latency-bound and keep their loops.  The same
    compares in the same order either way: no bit changes."""
    return window if window == SCAN_WIDTH and lanes == 1 else 0


def fleet_warps(num_samples: int) -> int:
    """Warps per scenario for fleet_kernel, from K's 32-sample slots: one
    warp for one slot, two for two or three (two samples a lane at three),
    four for four (one sample a lane, sim_kernel's layout).

    At 64 registers a thread (4 resident blocks of 256 threads an SM), a
    lane that carries four samples spilled; at K=128 one sample a lane ran
    fastest (PERF.md)."""
    slots = -(-num_samples // 32)
    return 1 if slots == 1 else 2 if slots <= 3 else 4


def _check_cluster(cluster: int, num_samples: int) -> None:
    nwarp = sim_threads(num_samples) // 32
    if cluster not in CLUSTER_SIZES or nwarp % cluster:
        raise ValueError(
            f"cluster must be one of {CLUSTER_SIZES} and divide the "
            f"{nwarp} warps of a K={num_samples} scenario, got {cluster}")


def _check_config(cfg: MPPIConfig) -> None:
    cfg.validate()
    if cfg.filter_window > 2 * cfg.horizon:
        raise ValueError(
            f"filter_window (= {cfg.filter_window}) must be <= 2 * horizon "
            f"(= {2 * cfg.horizon}): the fused loop reflects the median "
            f"window once at each edge")
    if cfg.num_samples > MAX_SAMPLES:
        raise ValueError(f"the fused loop takes K <= {MAX_SAMPLES} samples, "
                         f"got {cfg.num_samples}")


def _check_tensor(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _operands(arm, cfg, sim, ref_path, q0, dq0, u_prev, wp_idx, seed,
              n_steps, eps, step0):
    """Check the operands of a kernel launch and allocate its outputs.
    Raises on anything the kernels do not take.  Returns (params, state_f,
    state_i, rec, ufin)."""
    device = ref_path.device
    B, K, T = q0.shape[0], cfg.num_samples, cfg.horizon
    f32 = torch.float32
    if ref_path.shape[0] < 1 or n_steps < 0:
        raise ValueError(f"need a non-empty path and n_steps >= 0, got "
                         f"{ref_path.shape[0]} rows and {n_steps} steps")
    _check_tensor("ref_path", ref_path, (ref_path.shape[0], 4), f32, device)
    if ref_path.data_ptr() % 16:
        raise ValueError("ref_path must start on a 16-byte boundary: "
                         "sim_kernel reads its rows as float4")
    _check_tensor("q0", q0, (B, 2), f32, device)
    _check_tensor("dq0", dq0, (B, 2), f32, device)
    _check_tensor("u_prev", u_prev, (B, T, 2), f32, device)
    if eps is not None:
        _check_tensor("eps", eps, (B, n_steps, K, T, 2), f32, device)
    ints = []
    for name, v in (("wp_idx", wp_idx), ("seed", seed), ("step0", step0)):
        v = torch.as_tensor(v, device=device).reshape(-1)
        if v.shape[0] != B or v.dtype.is_floating_point:
            raise ValueError(f"{name} must hold {B} integers")
        ints.append(v)
    state_f = torch.cat([q0, dq0], dim=1).contiguous()
    state_i = torch.stack(ints, dim=1).to(torch.int32).contiguous()
    rec = torch.empty((B, n_steps, REC_LANES), dtype=f32, device=device)
    ufin = torch.empty((B, T, 2), dtype=f32, device=device)
    params = _sim_params(arm, cfg, sim, ref_path.shape[0], n_steps,
                         eps is None)
    return params, state_f, state_i, rec, ufin


def _raise_on(lib, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.mppi_error_string(err).decode())


def _launch(arm, cfg, sim, ref_path, q0, dq0, u_prev, wp_idx, seed, n_steps,
            eps, step0, cluster):
    """Launch csrc/sim_kernel.cu on the current stream, ``cluster`` blocks
    per scenario (None: :func:`cluster_size`)."""
    global LAUNCHES
    from ._build import load_library

    params, state_f, state_i, rec, ufin = _operands(
        arm, cfg, sim, ref_path, q0, dq0, u_prev, wp_idx, seed, n_steps, eps,
        step0)
    device = ref_path.device
    B, K, T = q0.shape[0], cfg.num_samples, cfg.horizon
    if cluster is None:
        cluster = cluster_size(B, K, torch.cuda.get_device_properties(
            device).multi_processor_count)
    scratch = (torch.empty((B, 2 * T, K), dtype=torch.float32, device=device)
               if eps is None else None)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mppi_sim_launch(
            ctypes.byref(params), B, cluster, _ptr(state_f),
            _ptr(state_i), _ptr(u_prev), _ptr(ref_path), _ptr(eps),
            _ptr(scratch), _ptr(rec), _ptr(ufin), ctypes.c_void_p(stream))
    _raise_on(lib, err, f"sim_kernel (cluster of {cluster} blocks)")
    LAUNCHES += 1
    return rec, ufin


def _launch_fleet(arm, cfg, sim, ref_path, q0, dq0, u_prev, wp_idx, seed,
                  n_steps, eps, step0, group):
    """Launch csrc/fleet_kernel.cu on the current stream: :func:`fleet_warps`
    warps per scenario, ``group`` scenarios per block (at most 8 warps)."""
    global FLEET_LAUNCHES, FLEET_COMPILED_SCANS
    from ._build import load_library

    params, state_f, state_i, rec, ufin = _operands(
        arm, cfg, sim, ref_path, q0, dq0, u_prev, wp_idx, seed, n_steps, eps,
        step0)
    device = ref_path.device
    warps = fleet_warps(cfg.num_samples)
    scan_w = scan_width(cfg.search_idx_len)
    lib = load_library()
    scratch = None
    if eps is None:          # PRNG mode: the ε store, [slot][t][c][lane]
        per = lib.mppi_fleet_scratch_floats(ctypes.byref(params))
        scratch = torch.empty((q0.shape[0], per), dtype=torch.float32,
                              device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mppi_fleet_launch(
            ctypes.byref(params), q0.shape[0], group, warps, scan_w,
            _ptr(state_f), _ptr(state_i), _ptr(u_prev), _ptr(ref_path),
            _ptr(eps), _ptr(scratch), _ptr(rec), _ptr(ufin),
            ctypes.c_void_p(stream))
    _raise_on(lib, err, f"fleet_kernel ({warps} warps a scenario)")
    FLEET_LAUNCHES += 1
    FLEET_COMPILED_SCANS += bool(scan_w)
    return rec, ufin


def fused_sim_run_batched(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                          ref_path: torch.Tensor,   # (N, 4) f32
                          q0: torch.Tensor,         # (B, 2) f32
                          dq0: torch.Tensor,        # (B, 2) f32
                          u_prev: torch.Tensor,     # (B, T, 2) f32
                          wp_idx,                   # (B,) int
                          seed,                     # (B,) int, 31-bit
                          n_steps: int,
                          eps: Optional[torch.Tensor] = None,
                          step0=None,               # (B,) int absolute step
                          group: int = 1,           # scenarios per block
                          cluster: Optional[int] = None):
    """Run B scenarios × ``n_steps`` closed-loop steps in one launch.

    Any CUDA operand launches a kernel or raises: ``csrc/fleet_kernel.cu``
    when ``1 < group <= 8`` and K <= 128, ``csrc/sim_kernel.cu`` for any
    other ``group`` (the JAX package's interleave for larger K is a TPU
    lever; sim_kernel gives the same results) on ``cluster`` blocks per
    scenario (None: :func:`cluster_size`; a cluster the card cannot place
    raises).  Only when every tensor lies on the CPU does a plain version
    run: :func:`fused_sim_reference_stacked` for ``group > 1``,
    :func:`fused_sim_reference` otherwise.  ``B`` must be divisible by
    ``group``.  Per scenario, every route and every cluster size gives the
    same results.  Returns (records (B, n_steps, 12) f32, u_final (B, T, 2)
    f32).
    """
    _check_config(cfg)
    B = q0.shape[0]
    if group < 1 or B % group:
        raise ValueError(f"B={B} is not divisible by group={group}")
    fleet = 1 < group <= FLEET_MAX_GROUP and (cfg.num_samples
                                              <= FLEET_MAX_SAMPLES)
    if cluster is not None:
        if fleet:
            raise ValueError(f"cluster applies to sim_kernel; group={group} "
                             f"takes fleet_kernel")
        _check_cluster(cluster, cfg.num_samples)
    if step0 is None:
        step0 = torch.zeros(B, dtype=torch.int64, device=ref_path.device)
    kinds = {v.device.type for v in (ref_path, q0, dq0, u_prev, eps, wp_idx,
                                     seed, step0)
             if isinstance(v, torch.Tensor)}
    args = (arm, cfg, sim, ref_path, q0, dq0, u_prev, wp_idx, seed, n_steps,
            eps, step0)
    if kinds == {"cpu"}:
        if group > 1:
            return fused_sim_reference_stacked(*args)
        return fused_sim_reference(*args)
    if "cuda" not in kinds:
        raise ValueError(f"fused_sim_run_batched runs on CUDA or CPU "
                         f"tensors, got {sorted(kinds)}")
    # any CUDA operand takes a kernel, which raises on mixed devices
    if fleet:
        return _launch_fleet(*args, group)
    return _launch(*args, cluster)


def fused_sim_run(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                  ref_path: torch.Tensor, q0, dq0, u_prev, wp_idx, seed,
                  n_steps: int, eps: Optional[torch.Tensor] = None,
                  step0=None, cluster: Optional[int] = None):
    """Single-scenario shim over :func:`fused_sim_run_batched`: q0/dq0 (2,),
    u_prev (T, 2), eps (n_steps, K, T, 2).  Returns (records (n_steps, 12),
    u_final (T, 2))."""
    device = ref_path.device
    one = lambda v: torch.as_tensor(v, device=device).reshape(1)
    rec, ufin = fused_sim_run_batched(
        arm, cfg, sim, ref_path, q0[None], dq0[None], u_prev[None],
        one(wp_idx), one(seed), n_steps,
        eps=None if eps is None else eps[None],
        step0=None if step0 is None else one(step0), cluster=cluster)
    return rec[0], ufin[0]
