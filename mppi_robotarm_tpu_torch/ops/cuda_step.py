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
  step needs no head launch.

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
the tail's layout (:func:`step_tail_layout`).  A launch copies nothing from
the host, so both can be captured in a CUDA graph; each adds one to its
count (:data:`HEAD_LAUNCHES`, :data:`TAIL_LAUNCHES`, and
:data:`CARRIED_HEADS` for a tail that carries the head) where it launches,
at capture for a captured one.
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

# Launches of step_head_kernel and step_tail_kernel, and the tail launches
# that carried the next step's head; a run that must show it went through
# them reads these before and after.
HEAD_LAUNCHES = 0
TAIL_LAUNCHES = 0
CARRIED_HEADS = 0

MAX_THREADS = 1024            # the statistics' logical lanes at most
# (lanes, cap) of each step_tail_kernel the library holds (the switch of
# csrc/step_kernel.cu::mppi_step_tail_launch): four logical lanes a lane
# with a sample each in registers (K <= MAX_THREADS), and two that read S
# again each pass (any K)
TAIL_BUILT = frozenset({(4, 1), (2, 0)})


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

    warps: int    # statistics warps a scenario, beside its control warp
    lanes: int    # logical lanes a physical lane (logical warps a warp)
    group: int    # scenarios a block
    cap: int      # samples a logical lane in registers (0: S read each pass)


def step_tail_layout(K: int, B: int, sm_count: Optional[int] = None
                     ) -> TailLayout:
    """The tail's layout for B scenarios of K samples on a card of
    ``sm_count`` SMs.  Up to K = :data:`MAX_THREADS` a logical lane holds
    one sample and a lane four logical lanes (8 statistics warps at K =
    1024, one at K <= 128); above it a lane holds two logical lanes, which
    read S again each pass.  While the batch leaves SMs free a block holds
    one scenario, else as many as make 8 warps."""
    nw = step_tail_threads(K) // 32
    lanes, cap = (4, 1) if K <= MAX_THREADS else (2, 0)
    warps = -(-nw // lanes)
    group = 1
    if sm_count is not None and B > sm_count:
        group = max(1, 8 // (warps + 1))
    return TailLayout(warps, lanes, min(group, B), cap)


def tail_layout_fits(layout: TailLayout) -> bool:
    """Whether ``step_tail_kernel`` takes ``layout``: built for its lanes
    and cap, a block within the threads its build's registers allow (576
    with several statistics warps a scenario or cap 0, 1024 with one
    statistics warp of cap 1), and at most 15 scenarios a block where they
    need named barriers (several statistics warps);
    csrc/step_kernel.cu::launch_tail checks the same, and that a cap of 1
    holds a logical lane's samples (K <= :data:`MAX_THREADS`)."""
    narrow = layout.warps == 1 and layout.cap == 1
    return ((layout.lanes, layout.cap) in TAIL_BUILT and layout.group >= 1
            and layout.group * (layout.warps + 1) * 32
            <= (1024 if narrow else 576)
            and (layout.warps == 1 or layout.group <= 15))


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
                    row: Optional[tuple] = None, carry_head: bool = False):
    """Plain version of the tail for B scenarios, in the dtypes of its
    inputs: the state before the step (step, q, dq, u_prev, wp_idx, done),
    the head's new index and path end, the solve's updated controls u_seq
    (B, T, 2) and costs s (B, K), and the run's step counter ``clock``
    (B,) or None.  Writes the step's record row into ``row`` (twelve (B,
    ...) tensors in ``SimRecord``'s field order; needs ``clock``) when
    given.  Returns the state after the step (step, q, dq, u_prev,
    wp_idx, done) and clock + 1 (None without a clock), and with
    ``carry_head`` also the next step's head, :func:`step_head_plain` on
    that state.  It is also the eager backend's step tail on any device
    (``sim/loop.py::_eager_step``)."""
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
        w = mppi_weights(s, cfg.lam)
        zero = lambda v: torch.where(
            done.view(-1, *(1,) * (v.dim() - 1)), torch.zeros_like(v), v)
        idx = torch.clamp(clock + 1, max=ref.shape[0] - 1)
        for dst, v in zip(row, (
                nq, out[2], zero(u0), torch.stack([x2, y2], dim=-1),
                torch.stack([x1, y1], dim=-1), ref[idx, 0:2], out[4],
                zero(torch.amin(s, dim=-1)),
                zero(ordered_sum(s) / cfg.num_samples),
                zero(effective_sample_size(w)), zero(weight_entropy(w)),
                done)):
            dst.copy_(v)
    if carry_head:
        return (*out, step_head_plain(cfg, ref, out[1], out[2], out[4]))
    return out


@functools.lru_cache(maxsize=64)
def _tail_layout_on(K: int, B: int, device: torch.device) -> TailLayout:
    """:func:`step_tail_layout` on ``device``'s SM count, resolved once a
    shape (the eager loop calls the tail every step)."""
    from .cuda_solve import _sm_count

    return step_tail_layout(K, B, _sm_count(device))


def _tail_launch(arm, cfg, sim, ref, state, wp_new, path_end, u_seq, s,
                 clock, row, carry_head=False,
                 layout: Optional[TailLayout] = None):
    """The tail kernel's launch; ``layout`` (default
    :func:`step_tail_layout` on this card) forces one, for the layout
    A/Bs of ``tools/fused_timing.py --split --tail-layouts`` and the card
    tests."""
    global TAIL_LAUNCHES, CARRIED_HEADS
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
    written = row
    if row is not None:
        if len(row) != len(_TAIL_ROW):
            raise ValueError(f"a record row is {len(_TAIL_ROW)} tensors, "
                             f"got {len(row)}")
        # a float row of another dtype is written through a float32 copy
        written = tuple(
            torch.empty(t.shape, dtype=f32, device=t.device)
            if _f32(t) is not t else t for t in row)
        for name, t, (shape, dtype) in zip(_TAIL_ROW, written, (
                (b2, f32),) * 6 + (((B,), i64),) + (((B,), f32),) * 4
                + (((B,), bb),)):
            _check_tensor(name, t, shape, dtype, device)
    ptrs = [None if t is None else t.data_ptr()
            for t in (*ins.values(), *outs, *(written or (None,) * 12))]
    args = _TailArgs(*ptrs)
    head, head_args = (_head_outputs(B, cfg.search_idx_len, device)
                       if carry_head else (None, None))
    if layout is None:
        layout = _tail_layout_on(K, B, device)
    params = _step_params(arm, cfg, sim, ref.shape[0])
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_step_tail_launch(
            ctypes.byref(params), ctypes.byref(args),
            None if head_args is None else ctypes.byref(head_args), B,
            step_tail_threads(K), layout.lanes, layout.cap, layout.group,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError(f"step_tail_kernel launch failed ({layout}): "
                           + lib.mppi_error_string(err).decode())
    TAIL_LAUNCHES += 1
    CARRIED_HEADS += int(carry_head)
    for dst, t in zip(row or (), written or ()):
        if dst is not t:
            dst.copy_(t)
    nxt = (*(v.to(d) for v, d in zip(outs, dtypes)), outs[6])
    if not carry_head:
        return nxt
    x0, wp, end, window = head
    return (*nxt, (x0.to(dtypes[1]), wp, end, window.to(ref_dtype)))


def step_tail(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
              ref: torch.Tensor, step, q, dq, u_prev, wp_idx, done, wp_new,
              path_end, u_seq, s, clock=None, row: Optional[tuple] = None,
              carry_head: bool = False):
    """The step's tail (see the module docstring and
    :func:`step_tail_plain` for the arguments and results): CUDA tensors
    launch ``step_tail_kernel`` in the layout of :func:`step_tail_layout`
    (contiguous float, int64 and bool tensors; it runs in float32, float
    operands cast to it and the results, the record row and the carried
    head back to their dtypes) or raise; CPU tensors take
    :func:`step_tail_plain`.  With ``carry_head`` the results end with the
    next step's head, (x0, index, path_end, window) as :func:`step_head`
    gives them on the new state."""
    state = (step, q, dq, u_prev, wp_idx, done)
    kinds = _kinds(ref, *state, wp_new, path_end, u_seq, s, clock,
                   *(row or ()))
    if kinds == {"cpu"}:
        return step_tail_plain(arm, cfg, sim, ref, *state, wp_new, path_end,
                               u_seq, s, clock, row, carry_head)
    return _tail_launch(arm, cfg, sim, ref, state, wp_new, path_end, u_seq,
                        s, clock, row, carry_head)
