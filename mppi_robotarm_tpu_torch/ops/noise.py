"""MPPI exploration noise.

The covariance factors are NumPy (config data, computed once on the host).
``sample_epsilon`` draws ε ~ N(0, Σ) from an explicit ``torch.Generator``,
never from global RNG state.  The fused closed loop draws its noise from a
counter-based Philox stream instead (``ops/cuda_rollout.py``); parity tests
inject ε made with NumPy into both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def sigma_cholesky(sigma) -> np.ndarray:
    """Lower-triangular Cholesky factor of the (2,2) noise covariance."""
    return np.linalg.cholesky(np.asarray(sigma, dtype=np.float64))


def sigma_inverse(sigma) -> np.ndarray:
    """Σ⁻¹ for the control-affine cost term γ·uᵀΣ⁻¹v (control.py:106)."""
    return np.linalg.inv(np.asarray(sigma, dtype=np.float64))


def sample_epsilon(generator: torch.Generator, num_samples: int,
                   horizon: int, chol, dtype=torch.float32) -> torch.Tensor:
    """Draw ε ~ N(0, Σ) of shape (K, T, 2) as ``N(0, I) @ chol(Σ)ᵀ`` on the
    generator's device."""
    z = torch.randn((num_samples, horizon, 2), generator=generator,
                    dtype=dtype, device=generator.device)
    return z @ torch.as_tensor(chol, dtype=dtype, device=z.device).T
