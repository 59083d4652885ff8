"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package is the reference.  Data crosses between the two packages as
NumPy arrays only, and noise is made with NumPy from fixed seeds, so both
sides see identical inputs.  ``tests/conftest.py`` pins JAX to the CPU with
x64 enabled before this module is imported.
"""

import dataclasses

import numpy as np
import torch

import mppi_robotarm_tpu.config as jcfg
import mppi_robotarm_tpu_torch.config as pcfg

torch.set_num_threads(1)

SIGMA_SCALE = np.sqrt(20.0)     # the presets' Σ = 20·I


def eps_noise(seed: int, shape, dtype=np.float32) -> np.ndarray:
    """N(0, 20·I) noise of ``shape`` (..., 2) from a NumPy seed."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * SIGMA_SCALE).astype(dtype)


def configs(num_samples: int, horizon: int, **kw):
    """(JAX MPPIConfig, port MPPIConfig) with the same fields."""
    j = dataclasses.replace(jcfg.MPPIConfig(), num_samples=num_samples,
                            horizon=horizon, **kw)
    p = dataclasses.replace(pcfg.MPPIConfig(), num_samples=num_samples,
                            horizon=horizon, **kw)
    return j, p


def t(x, dtype=torch.float64) -> torch.Tensor:
    """NumPy (or nested sequence) → CPU tensor."""
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def n(x) -> np.ndarray:
    """Tensor or JAX array → NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
