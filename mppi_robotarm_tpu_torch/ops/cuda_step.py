"""The per-step loop's step body around the solve kernel: wrappers, CUDA
kernels, plain versions.

A chunk of the cuda-backend loop (``sim/loop.py``) is one :func:`step_head`
launch, then two launches a step on the card:

* :func:`step_head` — the observed state ``x0 = [q, dq]``, the waypoint
  advance (``fk_ee``, the nearest row of the window, the path-end flag) and
  the window at the new index, which the solve reads;
* the solve kernel (``ops/cuda_solve.py``);
* :func:`step_tail` — the freeze flag, the warm-start shift, the plant
  (:func:`plant_step`), the kept state and step counter, and, when given
  one, the step's record row, written in place: q, dq, u0, end effector,
  elbow, reference row, index, the costs' min and mean, the weights' ESS
  and entropy, done, zeroed where done as the record is; with
  ``carry_head`` also the next step's head on the new state, so the next
  step needs no head launch; with ``statistics=False`` all but the row's
  statistics, which :func:`step_stats` then writes in a launch of their
  own (the loop's branch above K = 1024, :func:`stats_branch`).

They are the port's counterpart of what XLA fuses around the Pallas solve
in the JAX package's jitted ``simulate`` (``mppi_robotarm_tpu/sim/loop.py::
sim_step``, ``:86``, under the scan at ``:122-163``).  The path is picked by
where the tensors lie: CUDA tensors launch ``csrc/step_kernel.cu`` (built
by ``ops/_build.py``, bound through ``ctypes``) or raise; CPU tensors take
:func:`step_head_plain` and :func:`step_tail_plain`, the torch code the
kernels replaced.  Nothing falls back from one to the other.

Bits: the head and the tail's state, controls, index, done, FK and
reference row are the plain versions' bit for bit (the same float32
operations in the same order), and the carried head is the head kernel's
on the tail's outputs; the statistics are sums over K in the kernel's
fixed order (:func:`tail_stats_ordered`), which depends on K alone, not on
the tail's layout (:func:`step_tail_layout`) nor on whether they run in
the tail's launch or their own.  A launch copies nothing from the host, so
all can be captured in a CUDA graph; each adds one to its count
(:data:`HEAD_LAUNCHES`, :data:`TAIL_LAUNCHES`, :data:`STATS_LAUNCHES`, and
:data:`CARRIED_HEADS` for a tail that carries the head,
:data:`CLUSTER_TAILS` for a tail that ran on a thread-block cluster)
where it launches, at capture for a captured one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ArmParams, MPPIConfig, SimConfig
from ..models.arm import arm_ddq, fk_ee, fk_full
from .cuda_sim import _ArmConsts, _arm_consts, _check_tensor
from .waypoint import update_waypoint_index
from .weights import (effective_sample_size, mppi_weights, ordered_sum,
                      weight_entropy)

# Launches of step_head_kernel, step_tail_kernel and step_stats_kernel
# (the tail's statistics launched on their own), the tail launches that
# carried the next step's head and those that ran on a cluster; a run
# that must show it went through them reads these before and after.
HEAD_LAUNCHES = 0
TAIL_LAUNCHES = 0
STATS_LAUNCHES = 0
CARRIED_HEADS = 0
CLUSTER_TAILS = 0

MAX_THREADS = 1024            # the statistics' logical lanes at most
# (lanes, cap) of each step_tail_kernel the library holds (the switch of
# csrc/step_kernel.cu::mppi_step_tail_launch): four logical lanes a lane
# with a sample each in registers (K <= MAX_THREADS), two that read S
# again each pass (any K), and, only on a thread-block cluster of
# TAIL_CLUSTER CTAs (CLUSTER_BUILD), one with up to 64 samples a logical
# lane kept in shared memory (K <= 64 * MAX_THREADS), taken above
# MAX_THREADS where its waves of clusters beat one block a scenario
TAIL_BUILT = frozenset({(4, 1), (2, 0), (1, 64)})
CLUSTER_BUILD = (1, 64)
TAIL_CLUSTER = 8              # CTAs a scenario: the portable cluster limit
# Samples a logical lane that pay for one wave of clusters: on the H100 a
# wave takes 10-14 us, one block a scenario 6.6 us at 4 samples a logical
# lane, 13.5 at 12, 24 at 24 and 75 at 64, so a wave for each 16 takes
# the cluster only where it is the faster (PERF.md's sweep)
CLUSTER_WAVE_SAMPLES = 16
# What a launch runs of the tail (csrc/step_kernel.cu::TailPart): all of
# it, its control warp alone, or its statistics alone
_WHOLE, _CONTROL, _STATS = 0, 1, 2
_STAT_LANES = ("r_cmin", "r_cmean", "r_ess", "r_ent")


class _StepParams(ctypes.Structure):
    """Mirror of ``StepParams`` in csrc/step_kernel.cu, field for field."""

    _fields_ = [
        ("arm", _ArmConsts),
        ("l1c", ctypes.c_float), ("l2c", ctypes.c_float),
        ("dist_scale", ctypes.c_float), ("dt_p", ctypes.c_float),
        ("dist1", ctypes.c_float), ("dist2", ctypes.c_float),
        ("inv_lam", ctypes.c_float), ("inv_k", ctypes.c_float),
        ("K", ctypes.c_int), ("T", ctypes.c_int), ("W", ctypes.c_int),
        ("n_ref", ctypes.c_int),
    ]


_P = ctypes.c_void_p


class _HeadArgs(ctypes.Structure):
    """Mirror of ``HeadArgs`` in csrc/step_kernel.cu."""

    _fields_ = [(n, _P) for n in ("q", "dq", "wp", "ref", "x0", "wp_out",
                                  "path_end", "window")] + [
        ("q_stride", ctypes.c_int), ("dq_stride", ctypes.c_int)]


_TAIL_IN = ("step", "q", "dq", "u_prev", "wp", "done", "wp_new", "path_end",
            "u_seq", "s", "ref", "clock")
_TAIL_OUT = ("step_out", "q_out", "dq_out", "u_out", "wp_out", "done_out",
             "clock_out")
_TAIL_ROW = ("r_q", "r_dq", "r_u", "r_ee", "r_elbow", "r_ref", "r_wp",
             "r_cmin", "r_cmean", "r_ess", "r_ent", "r_done")


class _TailArgs(ctypes.Structure):
    """Mirror of ``TailArgs`` in csrc/step_kernel.cu."""

    _fields_ = [(n, _P) for n in _TAIL_IN + _TAIL_OUT + _TAIL_ROW]


def step_tail_threads(K: int) -> int:
    """The statistics' logical lanes n: K rounded up to a warp, at most
    :data:`MAX_THREADS`.  It sets the order of the statistics' sums
    (:func:`tail_stats_ordered`), so it depends on K alone."""
    return min(MAX_THREADS, -(-K // 32) * 32)


class TailLayout(NamedTuple):
    """How ``step_tail_kernel`` runs a scenario's statistics on the card;
    no layout moves a bit."""

    warps: int    # statistics warps a block (a CTA), beside a control warp
    lanes: int    # logical lanes a physical lane (logical warps a warp)
    group: int    # scenarios a block
    cap: int      # samples a logical lane kept on chip (0: S read each pass)
    cluster: int = 1   # CTAs a scenario (1: one block, no cluster)


# The tail's control warp launched without its statistics
# (``step_tail(statistics=False)``): no statistics warps, one scenario a
# block (the loop splits the tail only while the batch leaves SMs free)
CONTROL_LAYOUT = TailLayout(0, 2, 1, 0)


def step_tail_layout(K: int, B: int, sm_count: Optional[int] = None,
                     cluster_slots: int = 0) -> TailLayout:
    """The tail's layout for B scenarios of K samples on a card of
    ``sm_count`` SMs that holds ``cluster_slots`` clusters of the
    clustered build at once (:func:`_cluster_slots`).  Up to K =
    :data:`MAX_THREADS` a logical lane holds one sample and a lane four
    logical lanes (8 statistics warps at K = 1024, one at K <= 128).
    Above it a scenario runs on a cluster of :data:`TAIL_CLUSTER` CTAs,
    each CTA's 4 warps of one logical lane a lane owning its samples, kept
    in shared memory, where a logical lane's samples fit the clustered
    build's cap and the clusters take at most one wave of the card's
    slots for each :data:`CLUSTER_WAVE_SAMPLES` samples a logical lane;
    else a lane holds two logical lanes, which read S again each pass.
    While the batch leaves SMs free a block holds one scenario, else as
    many as make 8 warps."""
    n = step_tail_threads(K)
    nw = n // 32
    per_lane = -(-K // n)
    if (K > MAX_THREADS and per_lane <= CLUSTER_BUILD[1]
            and B <= cluster_slots * (per_lane // CLUSTER_WAVE_SAMPLES)):
        lanes, cap = CLUSTER_BUILD
        return TailLayout(nw // (lanes * TAIL_CLUSTER), lanes, 1, cap,
                          TAIL_CLUSTER)
    lanes, cap = (4, 1) if K <= MAX_THREADS else (2, 0)
    warps = -(-nw // lanes)
    group = 1
    if sm_count is not None and B > sm_count:
        group = max(1, 8 // (warps + 1))
    return TailLayout(warps, lanes, min(group, B), cap)


def tail_layout_fits(layout: TailLayout, K: Optional[int] = None) -> bool:
    """Whether ``step_tail_kernel`` takes ``layout`` (at K samples, when
    given): built for its lanes and cap, with a cap that holds a logical
    lane's samples; without a cluster, a block within the threads its
    build's registers allow (576 with several statistics warps a scenario
    or cap 0, 1024 with one statistics warp of cap 1) and at most 15
    scenarios a block where they need named barriers (several statistics
    warps); the clustered build (:data:`CLUSTER_BUILD`, only on a cluster)
    on :data:`TAIL_CLUSTER` CTAs, one scenario a cluster, its warps
    splitting all :data:`MAX_THREADS` logical lanes evenly over the CTAs.
    csrc/step_kernel.cu::launch_tail and launch_tail_cluster check the
    same."""
    lanes, cap, C = layout.lanes, layout.cap, layout.cluster
    clustered = (lanes, cap) == CLUSTER_BUILD
    if ((lanes, cap) not in TAIL_BUILT or layout.group < 1
            or C != (TAIL_CLUSTER if clustered else 1)):
        return False
    if K is not None and cap and -(-K // step_tail_threads(K)) > cap:
        return False
    if clustered:
        return (layout.group == 1
                and layout.warps * lanes * C == MAX_THREADS // 32
                and (K is None or step_tail_threads(K) == MAX_THREADS))
    narrow = layout.warps == 1 and cap == 1
    return (layout.group * (layout.warps + 1) * 32
            <= (1024 if narrow else 576)
            and (layout.warps == 1 or layout.group <= 15))


def stats_branch(K: int, B: int, sm_count: Optional[int],
                 plan: tuple) -> bool:
    """Whether the per-step loop's chunk (``sim/loop.py::_steps_into``)
    runs the tail's statistics as their own launch on a branch beside the
    next step's solve, the control tail alone between two solves: above K
    = :data:`MAX_THREADS` (below it the statistics cost about 0.7 us
    beside the control warp, less than a launch), where the solve kernel's
    blocks under ``plan`` ((tile, n_tiles, lanes, group) of
    ``cuda_solve._plan``: ceil(n_tiles / group) blocks a scenario) leave
    the SMs of a card of ``sm_count`` SMs that the statistics' blocks
    take, one an SM (:func:`step_tail_layout` with no cluster slots: a
    scenario's statistics in one block).  Off the card (``sm_count``
    None) never."""
    if sm_count is None or K <= MAX_THREADS:
        return False
    _, n_tiles, _, group = plan
    solve_blocks = B * -(-n_tiles // group)
    stats_blocks = -(-B // step_tail_layout(K, B, sm_count).group)
    return solve_blocks + stats_blocks <= sm_count


def tail_stats_ordered(s: torch.Tensor, lam: float):
    """The step tail's statistics of costs ``s`` (B, K) float32 in the
    kernel's order, in torch ops: (min, mean, ESS, entropy), each (B,).

    n = :func:`step_tail_threads` (K) logical lanes; lane t takes samples
    t, t + n, ... in order (a min and a sum from 0), each logical warp of
    32 lanes folds by an xor butterfly (16, 8, 4, 2, 1; lane 0's result),
    the warps' results are folded in warp order (the sum from 0).  e =
    exp(-(s - min) * fl(1/lam)), eta = the sum of e; w = e / eta, ESS = 1
    / the sum of w^2, entropy = -(the sum of w log max(w, 1e-38) over w >
    0), mean = the sum of s times fl(1/K).  Exact float32 operations, so
    it gives the kernel's bits wherever torch's exp and log give
    ``expf``'s and ``logf``'s."""
    f32 = torch.float32
    B, K = s.shape
    n = step_tail_threads(K)
    chunks = [s[:, i:i + n] for i in range(0, K, n)]
    pad = lambda c, v: torch.nn.functional.pad(c, (0, n - c.shape[1]),
                                               value=v)
    lanes = torch.arange(32, device=s.device)

    def fold(acc, op, first):
        """Lane sums (B, n) -> the kernel's total (B,)."""
        v = acc.view(B, n // 32, 32)
        for o in (16, 8, 4, 2, 1):
            v = op(v, v[..., lanes ^ o])
        v = v[..., 0]
        t = v[:, 0] if first else torch.zeros(B, dtype=f32, device=s.device)
        for w in range(1 if first else 0, n // 32):
            t = op(t, v[:, w])
        return t

    def nan_min(a, b):
        return torch.where(torch.isnan(a), a, torch.where(
            torch.isnan(b), b, torch.minimum(a, b)))

    add = lambda a, b: a + b
    mn = torch.full((B, n), float("inf"), dtype=f32, device=s.device)
    sm = torch.zeros((B, n), dtype=f32, device=s.device)
    for c in chunks:
        mn = nan_min(mn, pad(c, float("inf")))
        sm = sm + pad(c, 0.0)
    rho = fold(mn, nan_min, True)
    total = fold(sm, add, False)
    inv_lam = torch.tensor(float(np.float32(1.0) / np.float32(lam)),
                           dtype=f32, device=s.device)
    e = [torch.exp(-(c - rho[:, None]) * inv_lam) for c in chunks]
    eta_l = torch.zeros((B, n), dtype=f32, device=s.device)
    for c in e:
        eta_l = eta_l + pad(c, 0.0)
    eta = fold(eta_l, add, False)
    w2 = torch.zeros((B, n), dtype=f32, device=s.device)
    wl = torch.zeros((B, n), dtype=f32, device=s.device)
    for c in e:
        w = c / eta[:, None]
        w2 = w2 + pad(w * w, 0.0)
        wl = wl + pad(torch.where(
            w > 0, w * torch.log(torch.clamp_min(w, 1e-38)),
            torch.zeros_like(w)), 0.0)
    inv_k = torch.tensor(float(np.float32(1.0) / np.float32(K)), dtype=f32,
                         device=s.device)
    one = torch.ones(B, dtype=f32, device=s.device)
    return (rho, total * inv_k, one / fold(w2, add, False),
            -fold(wl, add, False))


@functools.lru_cache(maxsize=64)
def _step_params(arm: Optional[ArmParams], cfg: MPPIConfig,
                 sim: Optional[SimConfig], n_ref: int) -> _StepParams:
    """The kernels' parameter block, cached by its arguments (the frozen
    configs hash); callers never modify it.  The head reads neither the
    arm nor the plant (None leaves their fields 0).  ``inv_lam`` is 1/λ
    rounded as torch rounds a scalar divisor on the card (float32 1 /
    float32 λ), ``inv_k`` the factor of torch.mean."""
    f32 = np.float32
    p = _StepParams(
        l1c=cfg.l1, l2c=cfg.l2, dist_scale=cfg.dist_scale,
        inv_lam=float(f32(1.0) / f32(cfg.lam)),
        inv_k=float(f32(1.0) / f32(cfg.num_samples)), K=cfg.num_samples,
        T=cfg.horizon, W=cfg.search_idx_len, n_ref=n_ref)
    if arm is not None:
        p.arm = _arm_consts(arm)
    if sim is not None:
        p.dt_p, p.dist1, p.dist2 = sim.dt, *sim.disturbance
    return p


def plant_step(arm: ArmParams, sim: SimConfig, q, dq, u):
    """Plant integration ``dq += dt·ddq; q += dt·dq_new`` (run.py:53-55),
    with the optional constant disturbance torque; q, dq, u (..., 2)."""
    ddq1, ddq2 = arm_ddq(q[..., 0], q[..., 1], dq[..., 0], dq[..., 1],
                         u[..., 0] + sim.disturbance[0],
                         u[..., 1] + sim.disturbance[1], arm)
    dq = dq + sim.dt * torch.stack([ddq1, ddq2], dim=-1)
    q = q + sim.dt * dq
    return q, dq


def _kinds(*tensors) -> set:
    return {t.device.type for t in tensors if isinstance(t, torch.Tensor)}


def _f32(t):
    """A float tensor in float32 (itself if it is already); anything else
    as it is, for the launchers' checks."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(torch.float32)
    return t


# ---- the head ---------------------------------------------------------------

def step_head_plain(cfg: MPPIConfig, ref: torch.Tensor, q, dq, wp_idx):
    """Plain version of the head for B scenarios: q, dq (B, 2) (views with
    a row stride are taken), wp_idx (B,).  Returns (x0 (B, 4), the new
    index (B,), path_end (B,), window (B, W, 4)), x0 in the dtype of q and
    the window in that of the path."""
    x0 = torch.cat([q, dq], dim=-1)
    x, y = fk_ee(q[:, 0], q[:, 1], cfg.l1, cfg.l2)
    wp, window, _ = update_waypoint_index(ref, wp_idx, x, y,
                                          cfg.search_idx_len, cfg.dist_scale)
    return x0, wp, wp >= ref.shape[0] - 1, window


def _rows_of(name, t, B, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != (B, 2) \
            or t.stride(1) != 1:
        raise ValueError(f"{name} must be a ({B}, 2) {dtype} tensor on "
                         f"{device} with unit column stride, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _head_outputs(B, W, device):
    """The head's outputs, empty: x0 (B, 4), the index (B,), path_end
    (B,), the window (B, W, 4), and the ``_HeadArgs`` pointing at them
    (the inputs' fields unset)."""
    out = (torch.empty((B, 4), dtype=torch.float32, device=device),
           torch.empty((B,), dtype=torch.int64, device=device),
           torch.empty((B,), dtype=torch.bool, device=device),
           torch.empty((B, W, 4), dtype=torch.float32, device=device))
    return out, _HeadArgs(x0=out[0].data_ptr(), wp_out=out[1].data_ptr(),
                          path_end=out[2].data_ptr(),
                          window=out[3].data_ptr())


def _head_launch(cfg, ref, q, dq, wp_idx):
    global HEAD_LAUNCHES
    from ._build import load_library

    device, f32, i64 = ref.device, torch.float32, torch.int64
    B, W = q.shape[0], cfg.search_idx_len
    x_dtype, ref_dtype = q.dtype, ref.dtype
    ref, q, dq = _f32(ref), _f32(q), _f32(dq)
    _check_tensor("ref", ref, (ref.shape[0], 4), f32, device)
    _rows_of("q", q, B, f32, device)
    _rows_of("dq", dq, B, f32, device)
    _check_tensor("wp_idx", wp_idx, (B,), i64, device)
    if B < 1 or ref.shape[0] < 1:
        raise ValueError(f"need a scenario and a path row, got B={B}, "
                         f"{ref.shape[0]} rows")
    (x0, wp, path_end, window), args = _head_outputs(B, W, device)
    args.q, args.dq, args.wp, args.ref = (q.data_ptr(), dq.data_ptr(),
                                          wp_idx.data_ptr(), ref.data_ptr())
    args.q_stride, args.dq_stride = q.stride(0), dq.stride(0)
    params = _step_params(None, cfg, None, ref.shape[0])
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_step_head_launch(
            ctypes.byref(params), ctypes.byref(args), B,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError("step_head_kernel launch failed: "
                           + lib.mppi_error_string(err).decode())
    HEAD_LAUNCHES += 1
    return x0.to(x_dtype), wp, path_end, window.to(ref_dtype)


def step_head(cfg: MPPIConfig, ref: torch.Tensor, q, dq, wp_idx):
    """The step's head (see the module docstring): CUDA tensors launch
    ``step_head_kernel`` (in float32: float q, dq and path are cast to it
    and the results back to their dtypes; int64 index) or raise; CPU
    tensors take :func:`step_head_plain`.  Returns (x0 (B, 4), the new
    index, path_end, window (B, W, 4))."""
    kinds = _kinds(ref, q, dq, wp_idx)
    if kinds == {"cpu"}:
        return step_head_plain(cfg, ref, q, dq, wp_idx)
    return _head_launch(cfg, ref, q, dq, wp_idx)


# ---- the tail ---------------------------------------------------------------

def step_tail_plain(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                    ref: torch.Tensor, step, q, dq, u_prev, wp_idx, done,
                    wp_new, path_end, u_seq, s, clock=None,
                    row: Optional[tuple] = None, carry_head: bool = False,
                    statistics: bool = True):
    """Plain version of the tail for B scenarios, in the dtypes of its
    inputs: the state before the step (step, q, dq, u_prev, wp_idx, done),
    the head's new index and path end, the solve's updated controls u_seq
    (B, T, 2) and costs s (B, K), and the run's step counter ``clock``
    (B,) or None.  Writes the step's record row into ``row`` (twelve (B,
    ...) tensors in ``SimRecord``'s field order; needs ``clock``) when
    given, without ``statistics`` all but its statistics lanes
    (:func:`step_stats_plain` writes those).  Returns the state after the
    step (step, q, dq, u_prev, wp_idx, done) and clock + 1 (None without a
    clock), and with ``carry_head`` also the next step's head,
    :func:`step_head_plain` on that state.  It is also the eager backend's
    step tail on any device (``sim/loop.py::_eager_step``)."""
    done = done | path_end
    # solver.shift_warm_start: drop u[0], repeat the last row
    u_next = torch.cat([u_seq[..., 1:, :], u_seq[..., -1:, :]], dim=-2)
    u0 = u_next[:, 0]
    q_new, dq_new = plant_step(arm, sim, q, dq, u0)
    keep = lambda new, old: torch.where(
        done.view(-1, *(1,) * (new.dim() - 1)), old, new)
    out = (step + torch.where(done, 0, 1), keep(q_new, q), keep(dq_new, dq),
           keep(u_next, u_prev), keep(wp_new, wp_idx), done,
           None if clock is None else clock + 1)
    if row is not None:
        nq = out[1]
        x1, y1, x2, y2 = fk_full(nq[:, 0], nq[:, 1], arm)
        idx = torch.clamp(clock + 1, max=ref.shape[0] - 1)
        lanes = [nq, out[2], _zero(done, u0), torch.stack([x2, y2], dim=-1),
                 torch.stack([x1, y1], dim=-1), ref[idx, 0:2], out[4]]
        lanes += _stats_plain(cfg, s, done) if statistics else [None] * 4
        for dst, v in zip(row, (*lanes, done)):
            if v is not None:
                dst.copy_(v)
    if carry_head:
        return (*out, step_head_plain(cfg, ref, out[1], out[2], out[4]))
    return out


def _zero(done, v):
    """``v`` with the rows of the scenarios that are done zeroed."""
    return torch.where(done.view(-1, *(1,) * (v.dim() - 1)),
                       torch.zeros_like(v), v)


def _stats_plain(cfg: MPPIConfig, s, done) -> list:
    """The record row's statistics lanes of costs ``s`` (B, K) in torch's
    order: min, mean, the weights' ESS and entropy, zeroed where done."""
    w = mppi_weights(s, cfg.lam)
    return [_zero(done, v) for v in (
        torch.amin(s, dim=-1), ordered_sum(s) / cfg.num_samples,
        effective_sample_size(w), weight_entropy(w))]


def step_stats_plain(cfg: MPPIConfig, s, row: tuple) -> None:
    """Plain version of the tail's statistics launched on their own: the
    statistics lanes of the record ``row`` (twelve (B, ...) tensors in
    ``SimRecord``'s field order) from costs ``s`` (B, K), zeroed where the
    row's done lane (written by the tail with ``statistics=False``) is
    set."""
    for dst, v in zip(row[7:11], _stats_plain(cfg, s, row[11])):
        dst.copy_(v)


@functools.lru_cache(maxsize=None)
def _cluster_slots(device: torch.device) -> int:
    """How many clusters of the clustered tail ``device`` holds at once, as
    the kernel's launch asks it
    (csrc/step_kernel.cu::mppi_step_tail_cluster_slots); 0 where it places
    none, and off the card."""
    from ._build import load_library

    if device.type != "cuda":
        return 0
    slots = ctypes.c_int(0)
    with torch.cuda.device(device):
        lib = load_library()
        err = lib.mppi_step_tail_cluster_slots(ctypes.byref(slots))
    if err:
        raise RuntimeError("step_tail_kernel's cluster query failed: "
                           + lib.mppi_error_string(err).decode())
    return slots.value


@functools.lru_cache(maxsize=64)
def _tail_layout_on(K: int, B: int, device: torch.device) -> TailLayout:
    """:func:`step_tail_layout` on ``device``'s SM count and cluster slots,
    resolved once a shape (the eager loop calls the tail every step)."""
    from .cuda_solve import _sm_count

    return step_tail_layout(K, B, _sm_count(device), _cluster_slots(device))


def _written(row, B, device) -> Optional[tuple]:
    """The record row's tensors the kernel writes: each of ``row`` itself,
    or for a float lane of another dtype a float32 copy, checked against
    the kernel's shapes and dtypes; None for no row."""
    if row is None:
        return None
    if len(row) != len(_TAIL_ROW):
        raise ValueError(f"a record row is {len(_TAIL_ROW)} tensors, "
                         f"got {len(row)}")
    f32 = torch.float32
    written = tuple(torch.empty(t.shape, dtype=f32, device=t.device)
                    if _f32(t) is not t else t for t in row)
    for name, t, (shape, dtype) in zip(_TAIL_ROW, written, (
            ((B, 2), f32),) * 6 + (((B,), torch.int64),)
            + (((B,), f32),) * 4 + (((B,), torch.bool),)):
        _check_tensor(name, t, shape, dtype, device)
    return written


def _copy_back(row, written, skip=()) -> None:
    """The float32 copies of ``written`` into their lanes of ``row``, but
    the lanes named in ``skip``."""
    for name, dst, t in zip(_TAIL_ROW, row or (), written or ()):
        if dst is not t and name not in skip:
            dst.copy_(t)


def _tail_launch(arm, cfg, sim, ref, state, wp_new, path_end, u_seq, s,
                 clock, row, carry_head=False,
                 layout: Optional[TailLayout] = None,
                 statistics: bool = True):
    """The tail kernel's launch; ``layout`` (default
    :func:`step_tail_layout` on this card, or without ``statistics``
    :data:`CONTROL_LAYOUT`) forces one, for the layout A/Bs of
    ``tools/fused_timing.py --split --tail-layouts`` and the card
    tests."""
    global TAIL_LAUNCHES, CARRIED_HEADS, CLUSTER_TAILS
    from ._build import load_library

    device, f32, i64 = ref.device, torch.float32, torch.int64
    dtypes = [getattr(v, "dtype", None) for v in state]
    ref_dtype = ref.dtype
    step, q, dq, u_prev, wp_idx, done = map(_f32, state)
    u_seq, s, ref = _f32(u_seq), _f32(s), _f32(ref)
    B, K, T = q.shape[0], cfg.num_samples, cfg.horizon
    if B < 1 or ref.shape[0] < 1:
        raise ValueError(f"need a scenario and a path row, got B={B}, "
                         f"{ref.shape[0]} rows")
    if row is not None and clock is None:
        raise ValueError("a record row needs the run's step counter clock")
    b2, bb = (B, 2), torch.bool
    shapes = dict(step=((B,), i64), q=(b2, f32), dq=(b2, f32),
                  u_prev=((B, T, 2), f32), wp=((B,), i64), done=((B,), bb),
                  wp_new=((B,), i64), path_end=((B,), bb),
                  u_seq=((B, T, 2), f32), s=((B, K), f32),
                  ref=((ref.shape[0], 4), f32), clock=((B,), i64))
    ins = dict(zip(_TAIL_IN, (step, q, dq, u_prev, wp_idx, done, wp_new,
                              path_end, u_seq, s, ref, clock)))
    for name, t in ins.items():
        if t is not None:
            _check_tensor(name, t, *shapes[name], device)
    outs = [torch.empty_like(v) for v in (step, q, dq, u_prev, wp_idx, done)]
    outs.append(None if clock is None else torch.empty_like(clock))
    written = _written(row, B, device)
    ptrs = [None if t is None else t.data_ptr()
            for t in (*ins.values(), *outs, *(written or (None,) * 12))]
    args = _TailArgs(*ptrs)
    head, head_args = (_head_outputs(B, cfg.search_idx_len, device)
                       if carry_head else (None, None))
    if layout is None:
        layout = (_tail_layout_on(K, B, device) if statistics
                  else CONTROL_LAYOUT)
    params = _step_params(arm, cfg, sim, ref.shape[0])
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_step_tail_launch(
            ctypes.byref(params), ctypes.byref(args),
            None if head_args is None else ctypes.byref(head_args), B,
            step_tail_threads(K), layout.lanes, layout.cap, layout.group,
            layout.cluster, _WHOLE if statistics else _CONTROL,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError(f"step_tail_kernel launch failed ({layout}): "
                           + lib.mppi_error_string(err).decode())
    TAIL_LAUNCHES += 1
    CARRIED_HEADS += int(carry_head)
    CLUSTER_TAILS += int(layout.cluster > 1)
    _copy_back(row, written, () if statistics else _STAT_LANES)
    nxt = (*(v.to(d) for v, d in zip(outs, dtypes)), outs[6])
    if not carry_head:
        return nxt
    x0, wp, end, window = head
    return (*nxt, (x0.to(dtypes[1]), wp, end, window.to(ref_dtype)))


def step_tail(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
              ref: torch.Tensor, step, q, dq, u_prev, wp_idx, done, wp_new,
              path_end, u_seq, s, clock=None, row: Optional[tuple] = None,
              carry_head: bool = False, statistics: bool = True):
    """The step's tail (see the module docstring and
    :func:`step_tail_plain` for the arguments and results): CUDA tensors
    launch ``step_tail_kernel`` in the layout of :func:`step_tail_layout`
    (contiguous float, int64 and bool tensors; it runs in float32, float
    operands cast to it and the results, the record row and the carried
    head back to their dtypes), or without ``statistics`` its control warp
    alone in :data:`CONTROL_LAYOUT`, leaving the row's statistics lanes
    to :func:`step_stats`; or raise.  CPU tensors take
    :func:`step_tail_plain`.  With ``carry_head`` the results end with the
    next step's head, (x0, index, path_end, window) as :func:`step_head`
    gives them on the new state."""
    state = (step, q, dq, u_prev, wp_idx, done)
    kinds = _kinds(ref, *state, wp_new, path_end, u_seq, s, clock,
                   *(row or ()))
    if kinds == {"cpu"}:
        return step_tail_plain(arm, cfg, sim, ref, *state, wp_new, path_end,
                               u_seq, s, clock, row, carry_head, statistics)
    return _tail_launch(arm, cfg, sim, ref, state, wp_new, path_end, u_seq,
                        s, clock, row, carry_head, None, statistics)


def _stats_launch(cfg, s, row, beside: bool):
    """The statistics kernel's launch (``step_stats_kernel``) on the
    current stream ``beside`` a solve in one block a scenario
    (:func:`step_tail_layout` with no cluster slots), else in the tail's
    own layout."""
    global STATS_LAUNCHES
    from ._build import load_library
    from .cuda_solve import _sm_count

    device, s = s.device, _f32(s)
    B, K = s.shape[0], cfg.num_samples
    _check_tensor("s", s, (B, K), torch.float32, device)
    written = _written(row, B, device)
    args = _TailArgs(s=s.data_ptr(), **{
        name: t.data_ptr() for name, t in zip(_TAIL_ROW, written)})
    layout = (step_tail_layout(K, B, _sm_count(device)) if beside
              else _tail_layout_on(K, B, device))
    params = _step_params(None, cfg, None, 1)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_step_tail_launch(
            ctypes.byref(params), ctypes.byref(args), None, B,
            step_tail_threads(K), layout.lanes, layout.cap, layout.group,
            layout.cluster, _STATS,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError(f"step_stats_kernel launch failed ({layout}): "
                           + lib.mppi_error_string(err).decode())
    STATS_LAUNCHES += 1
    _copy_back(row, written, [n for n in _TAIL_ROW if n not in _STAT_LANES])


def step_stats(cfg: MPPIConfig, s, row: tuple, beside: bool = True):
    """The tail's statistics on their own, after a tail launched with
    ``statistics=False`` wrote the rest of the record ``row``: min, mean,
    ESS and entropy of costs ``s`` (B, K) into the row's statistics lanes,
    zeroed where its done lane is set, the kernel's bits
    (:func:`tail_stats_ordered`).  CUDA tensors launch
    ``step_stats_kernel``, ``beside`` a solve in one block a scenario
    (so it takes only the SMs the solve leaves), else in the tail's own
    layout (a cluster where it pays); or raise.  CPU tensors take
    :func:`step_stats_plain`."""
    if _kinds(s, *row) == {"cpu"}:
        return step_stats_plain(cfg, s, row)
    return _stats_launch(cfg, s, row, beside)
