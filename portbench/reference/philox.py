"""The exploration noise of the closed loop: the Philox4x32-10 stream.

Frozen copy of ``mppi_robotarm_tpu_torch/ops/cuda_rollout.py``
(``_mulhilo32``, ``philox4x32_10``, ``uniform_from_bits``, ``box_muller``,
``chol_terms``, ``_scale_chol``, ``philox_epsilon_batch``) at commit
d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7, with the floating-point part in a
dtype of the caller's choice.  The integer stream is exact in any dtype.

Scenario b of a step draws key (seed[b], step[b]) with counter (k, t, 0,
0); words 0 and 1 become two uniforms in (0, 1], then two normals by
Box-Muller, then ε = chol(Σ)·z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the constant ``a`` times the uint32 values
    held in int64 ``b``, built from 16-bit halves so nothing overflows."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh
    low = al * bl + ((mid & 0xFFFF) << 16)
    hi = ah * bh + (mid >> 16) + (low >> 32)
    return hi, low & MASK32


def philox4x32_10(ctr, key):
    """Ten Philox rounds of counter words ``ctr`` (4 int64 tensors of
    uint32 values) under ``key`` (2 int64 tensors)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo32(_M0, c0)
        hi1, lo1 = _mulhilo32(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(bits: torch.Tensor, dtype) -> torch.Tensor:
    """uint32 (in int64) → (bits >> 8)·2^-24 + 2^-25, in (0, 1]."""
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def chol_terms(sigma):
    """(L11, L21, L22) of the Cholesky factor of the 2×2 covariance."""
    c = np.linalg.cholesky(np.asarray(sigma, dtype=np.float64))
    return float(c[0, 0]), float(c[1, 0]), float(c[1, 1])


def epsilon(seed: torch.Tensor, step: torch.Tensor, K: int, T: int, sigma,
            dtype) -> torch.Tensor:
    """ε (B, K, T, 2) of B solves in ``dtype``: scenario b keyed (seed[b],
    step[b]); ``seed`` and ``step`` (B,) int64 tensors on one device."""
    device = seed.device
    B = seed.shape[0]
    k = torch.arange(K, dtype=torch.int64, device=device)[None, :, None]
    t = torch.arange(T, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    key = lambda v: (v & MASK32)[:, None, None]
    w0, w1, _, _ = philox4x32_10(
        (k.expand(B, K, T), t.expand(B, K, T), zero, zero),
        (key(seed), key(step)))
    u1, u2 = uniform(w0, dtype), uniform(w1, dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    z1, z2 = r * torch.cos(theta), r * torch.sin(theta)
    l11, l21, l22 = chol_terms(sigma)
    return torch.stack([l11 * z1, l21 * z1 + l22 * z2], dim=-1)
