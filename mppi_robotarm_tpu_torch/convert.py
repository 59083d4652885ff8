"""Carry state and configs across from the JAX package, as NumPy values.

The port never imports JAX.  A caller that holds JAX arrays converts them
with ``np.asarray`` and hands the NumPy values (and the JAX package's
config dataclasses, read through ``dataclasses.asdict``) to these
functions, so that both packages start from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import ArmParams, MPPIConfig, SimConfig
from .device import resolve_device
from .mppi.solver import MPPIState
from .sim.loop import SimRecord, SimState


def seed_from_key_data(key_data) -> int:
    """The 31-bit seed the JAX fused loop derives from its key:
    ``key_data[-1] & 0x7FFFFFFF`` (``sim/loop.py:366-370``)."""
    return int(np.asarray(key_data).reshape(-1)[-1].astype(np.uint32)
               & np.uint32(0x7FFFFFFF))


def sim_state_from_numpy(step, q, dq, u_prev, wp_idx, key_data, done,
                         dtype=torch.float32, device=None) -> SimState:
    """The port's :class:`SimState` from a JAX ``SimState``'s values, on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    as_t = lambda v: torch.tensor(np.array(v), dtype=dtype, device=device)
    return SimState(
        step=torch.tensor(int(step), dtype=torch.int64, device=device),
        q=as_t(q), dq=as_t(dq),
        mppi=MPPIState(u_prev=as_t(u_prev),
                       wp_idx=torch.tensor(int(wp_idx), dtype=torch.int64,
                                           device=device)),
        seed=seed_from_key_data(key_data),
        done=torch.tensor(bool(done), device=device),
    )


def sim_state_batch_from_numpy(step, q, dq, u_prev, wp_idx, key_data, done,
                               dtype=torch.float32,
                               device=None) -> SimState:
    """The port's batched :class:`SimState` from a batched JAX ``SimState``
    (``init_sim_batch``): ``key_data`` (B, 2) gives each scenario's seed as
    :func:`seed_from_key_data` does.  On ``device``, default ``cuda``."""
    device = resolve_device(device)
    as_t = lambda v: torch.tensor(np.array(v), dtype=dtype, device=device)
    as_i = lambda v: torch.tensor(np.array(v), dtype=torch.int64,
                                  device=device)
    seeds = [seed_from_key_data(k) for k in np.asarray(key_data)]
    return SimState(
        step=as_i(step), q=as_t(q), dq=as_t(dq),
        mppi=MPPIState(u_prev=as_t(u_prev), wp_idx=as_i(wp_idx)),
        seed=as_i(seeds),
        done=torch.tensor(np.array(done), dtype=torch.bool, device=device),
    )


def _from_dataclass(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def arm_from_jax_config(arm) -> ArmParams:
    """The port's :class:`ArmParams` from the JAX package's."""
    return _from_dataclass(ArmParams, arm)


def mppi_from_jax_config(cfg) -> MPPIConfig:
    """The port's :class:`MPPIConfig` from the JAX package's."""
    return _from_dataclass(MPPIConfig, cfg)


def sim_from_jax_config(sim) -> SimConfig:
    """The port's :class:`SimConfig` from the JAX package's."""
    return _from_dataclass(SimConfig, sim)


def records_to_numpy(rec: SimRecord) -> SimRecord:
    """A :class:`SimRecord` of NumPy arrays, field for field."""
    return SimRecord(*(t.detach().cpu().numpy() for t in rec))
