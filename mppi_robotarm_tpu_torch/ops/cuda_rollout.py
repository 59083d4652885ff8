"""Plain-PyTorch twins of the device helpers in ``csrc/mppi_device.cuh``.

These are the per-sample pieces that the kernels (``csrc/sim_kernel.cu``,
``csrc/solve_kernel.cu``) inline, written once in torch with the same
operation order as the CUDA ``__device__`` functions, so that the plain
versions of the kernels (``ops/cuda_sim.py``, ``ops/cuda_solve.py``)
compute what the kernels do:

* ``philox4x32_10`` — the Random123 Philox4x32-10 counter-based generator.
  The 32×32→64-bit products are built from 16-bit halves, so no int64
  product overflows and the bits equal the device's ``__umulhi`` ones.
* ``uniform_from_bits`` / ``box_muller`` — the top 24 bits of a word as a
  uniform in (0, 1], then two normals (``ops/pallas_rollout.py:67-85``).
* ``philox_epsilon_batch`` — the noise of B solves: key (seed, absolute
  step), counter (k_offset + k, t, 0, 0), words 0 and 1;
  ``philox_epsilon`` — one closed-loop step's noise from the same stream.
* ``dynamics_step_trig`` / ``dynamics_step`` — the semi-implicit Euler step
  with the caller's cos/sin (``ops/pallas_rollout.py:123-183``), exact
  divide.
* ``tracking_cost`` — the frozen-window nearest-waypoint cost, exact
  metric, first-win ties (``ops/pallas_rollout.py:186-377``).
* ``rollout_cost_trig`` — the T-step rollout and cost of every sample with
  the trig carry, the loop both kernels run per sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ArmParams, MPPIConfig
from .noise import sigma_inverse

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_TWO_PI = 2.0 * math.pi


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values held in int64 ``b``, without int64 overflow."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh                       # < 2^33
    low = al * bl + ((mid & 0xFFFF) << 16)        # < 2^33
    hi = ah * bh + (mid >> 16) + (low >> 32)
    return hi, low & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 of counter words ``ctr`` (4 int64 tensors of uint32
    values) under ``key`` (2 ints or int64 tensors).  Returns 4 tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) → float32 in (0, 1]: (bits >> 8)·2^-24 + 2^-25."""
    b = (bits >> 8).to(torch.float32)
    return b * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """Two standard normals from two uniforms in (0, 1]."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def chol_terms(sigma):
    """(L11, L21, L22) of the Cholesky factor of Σ, as Python floats."""
    chol = np.linalg.cholesky(np.asarray(sigma, dtype=np.float64))
    return float(chol[0, 0]), float(chol[1, 0]), float(chol[1, 1])


def _scale_chol(z1, z2, cfg: MPPIConfig) -> torch.Tensor:
    """ε₁ = L11·z1, ε₂ = L21·z1 + L22·z2 (the factor rounded to f32)."""
    l11, l21, l22 = (_f32(v) for v in chol_terms(cfg.sigma))
    return torch.stack([l11 * z1, l21 * z1 + l22 * z2], dim=-1)


def philox_epsilon(seed: int, step: int, cfg: MPPIConfig,
                   device=None) -> torch.Tensor:
    """ε (K, T, 2) float32 of one closed-loop step, scaled by chol(Σ).

    Key (seed, step) — ``step`` is the absolute closed-loop step, so a
    chained or resumed run continues the stream; counter (k, t, 0, 0).
    """
    col = lambda v: torch.tensor([int(v) & _MASK32], dtype=torch.int64,
                                 device=device)
    return philox_epsilon_batch(col(seed), col(step), col(0),
                                cfg.num_samples, cfg)[0]


def philox_epsilon_batch(seed: torch.Tensor, step: torch.Tensor,
                         k_offset: torch.Tensor, num_samples: int,
                         cfg: MPPIConfig) -> torch.Tensor:
    """ε (B, K, T, 2) of B solves: scenario b draws key (seed[b], step[b])
    with counter (k_offset[b] + k, t, 0, 0), so it holds samples
    k_offset[b] .. k_offset[b] + K - 1 of :func:`philox_epsilon`'s stream.
    ``seed``/``step``/``k_offset`` are (B,) int64 tensors on one device."""
    device = seed.device
    B, T = seed.shape[0], cfg.horizon
    k = (k_offset[:, None, None]
         + torch.arange(num_samples, device=device)[None, :, None])
    t = torch.arange(T, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    key = lambda v: (v & _MASK32)[:, None, None]
    w0, w1, _, _ = philox4x32_10(
        ((k & _MASK32).expand(B, num_samples, T),
         t.expand(B, num_samples, T), zero, zero),
        (key(seed), key(step)))
    z1, z2 = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))
    return _scale_chol(z1, z2, cfg)


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the kernels receive it."""
    return float(np.float32(x))


def rollout_cost_trig(arm: ArmParams, cfg: MPPIConfig, q1, q2, dq1, dq2,
                      u: torch.Tensor, eps: torch.Tensor,
                      window: torch.Tensor, exploit: torch.Tensor):
    """Total cost S of noisy rollouts with the trig carry: the per-sample
    loop of both kernels (``csrc/sim_kernel.cu`` phase 2 and
    ``csrc/solve_kernel.cu`` pass 1), vectorised over the samples.

    Either one scenario — ``q1``..``dq2`` 0-d, ``u`` (T, 2), ``eps``
    (K, T, 2), ``window`` (W, 4), ``exploit`` (K,) — or B of them —
    ``q1``..``dq2`` (B, 1), ``u`` (B, T, 2), ``eps`` (B, K, T, 2),
    ``window`` (B, 1, W, 4), ``exploit`` (B, K).  Returns S (K,) or (B, K).
    """
    stage_w = tuple(_f32(w) for w in cfg.stage_cost_weight)
    term_w = tuple(_f32(w) for w in cfg.terminal_cost_weight)
    si0, si1, si2, si3 = (_f32(v) for v in sigma_inverse(cfg.sigma).ravel())
    c1, s1 = torch.cos(q1), torch.sin(q1)
    c12, s12 = torch.cos(q1 + q2), torch.sin(q1 + q2)
    r1, r2, rd1, rd2 = q1, q2, dq1, dq2
    s = torch.zeros(exploit.shape, dtype=torch.float32, device=eps.device)
    for t in range(u.shape[-2]):
        e1, e2 = eps[..., t, 0], eps[..., t, 1]
        u1r, u2r = u[..., t, 0, None], u[..., t, 1, None]
        v1 = torch.where(exploit, u1r + e1, e1)
        v2 = torch.where(exploit, u2r + e2, e2)
        if cfg.u_clamp is not None:
            v1 = torch.clamp(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = torch.clamp(v2, -cfg.u_clamp, cfg.u_clamp)
        c2 = c12 * c1 + s12 * s1          # q2 = (q1+q2) − q1
        s2 = s12 * c1 - c12 * s1
        r1, r2, rd1, rd2 = dynamics_step_trig(
            r1, r2, rd1, rd2, v1, v2, cfg.delta_t, arm, c1, c2, s2, c12)
        c1, s1 = torch.cos(r1), torch.sin(r1)
        r12 = r1 + r2
        c12, s12 = torch.cos(r12), torch.sin(r12)
        xr = cfg.l1 * c1 + cfg.l2 * c12
        yr = cfg.l1 * s1 + cfg.l2 * s12
        s = s + tracking_cost(xr, yr, rd1, rd2, window, stage_w, cfg)
        su1 = si0 * u1r + si1 * u2r
        su2 = si2 * u1r + si3 * u2r
        s = s + cfg.gamma * (v1 * su1 + v2 * su2)
    xr = cfg.l1 * c1 + cfg.l2 * c12
    yr = cfg.l1 * s1 + cfg.l2 * s12
    return s + tracking_cost(xr, yr, rd1, rd2, window, term_w, cfg)


def dynamics_step_trig(q1, q2, dq1, dq2, v1, v2, dt, p: ArmParams,
                       c1, c2, s2, c12):
    """Semi-implicit Euler step of the arm with the trig of the CURRENT
    state supplied by the caller: cos(q1), cos(q2), sin(q2), cos(q1+q2).
    Same expression order as the JAX kernels and the CUDA helper."""
    m11 = (p.m1 * p.lc1 ** 2 + p.l1
           + p.m2 * (p.l1 ** 2 + p.lc2 ** 2 + 2.0 * p.l1 * p.lc2 * c2) + p.l2)
    m12 = p.m2 * p.l1 * p.lc2 * c2 + p.m2 * p.lc2 ** 2 + p.l2
    m22 = p.m2 * p.lc2 ** 2 + p.l2
    h = p.m2 * p.l1 * p.lc2 * s2
    g1 = p.m1 * p.lc1 * p.g * c1 + p.m2 * p.g * (p.lc2 * c12 + p.l1 * c1)
    g2 = p.m2 * p.lc2 * p.g * c12
    r1 = v1 - (-h * dq2 * dq1 + (-h * dq1 - h * dq2) * dq2) - g1
    r2 = v2 - (h * dq1 * dq1) - g2
    det = m11 * m22 - m12 * m12
    inv_det = 1.0 / det
    ddq1 = (m22 * r1 - m12 * r2) * inv_det
    ddq2 = (-m12 * r1 + m11 * r2) * inv_det
    dq1 = dq1 + ddq1 * dt
    dq2 = dq2 + ddq2 * dt
    return q1 + dq1 * dt, q2 + dq2 * dt, dq1, dq2


def dynamics_step(q1, q2, dq1, dq2, v1, v2, dt, p: ArmParams):
    """:func:`dynamics_step_trig` with exact trig of the current state."""
    return dynamics_step_trig(q1, q2, dq1, dq2, v1, v2, dt, p,
                              torch.cos(q1), torch.cos(q2), torch.sin(q2),
                              torch.cos(q1 + q2))


def tracking_cost(x, y, dq1, dq2, window: torch.Tensor, weights,
                  cfg: MPPIConfig):
    """Nearest-waypoint tracking cost of end-effector positions (x, y).

    ``window`` (W, 4), or (B, 1, W, 4) against (B, K) positions, is the
    clamped window (rows past the path end repeat
    the last row, so no mask is needed: under first-win ties a duplicate
    never changes the selected values).  The metric is the exact
    ``(dx² + dy²)·dist_scale``; the cost is
    ``(w0·Δx² + w1·Δy² + w2·Δdq1² + w3·Δdq2²)·cost_scale``.
    """
    dx = x[..., None] - window[..., 0]
    dy = y[..., None] - window[..., 1]
    d = (dx * dx + dy * dy) * cfg.dist_scale
    j = torch.argmin(d, dim=-1)
    if window.dim() == 2:
        b = window[j]
    else:                       # (..., 1, W, 4): one window per scenario
        b = torch.take_along_dim(window, j[..., None, None], dim=-2)[..., 0, :]
    ex = x - b[..., 0]
    ey = y - b[..., 1]
    e1 = dq1 - b[..., 2]
    e2 = dq2 - b[..., 3]
    w0, w1, w2, w3 = weights
    return (w0 * (ex * ex) + w1 * (ey * ey) + w2 * (e1 * e1)
            + w3 * (e2 * e2)) * cfg.cost_scale
