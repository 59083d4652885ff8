"""The sample-sharded step's combine around its collectives: wrappers,
CUDA kernels, plain versions.

A rank of the sample-sharded step (``parallel/sharded.py``, cuda backend)
solves its K_local samples with ``normalize=False``, giving its minimum
cost m_s, η_s and the raw Σe·ε A_s; then MIN on m and:

* :func:`shard_scale` — the rescale to the common minimum, packed into one
  message for the SUM all-reduce: [η_s·exp((m − m_s)/λ),
  A_s·exp((m − m_s)/λ)], (..., B, 1 + 2T);
* :func:`shard_finish` — on the summed message: Σwε = A/η, the median
  filter over the horizon (any ``filter_window``) and u_seq = u_prev +
  median.

They stand for what XLA fuses around the collectives of the JAX package's
``_solve_local_pallas`` (``mppi_robotarm_tpu/parallel/sharded.py:139-152``).
CUDA tensors launch ``csrc/shard_kernel.cu`` (built by ``ops/_build.py``,
bound through ``ctypes``) or raise; CPU tensors take
:func:`shard_scale_plain` and :func:`shard_finish_plain`, the torch code
the kernels replaced.  Nothing falls back from one to the other.  The
kernels run in float32: float64 operands are cast to it and the results
back.  They give the plain versions' bits on the card (the same float32
operations in the same order; see the source).  A launch copies nothing
from the host, so it can be captured in a CUDA graph, and adds one to its
count, :data:`SCALE_LAUNCHES` or :data:`FINISH_LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import MPPIConfig
from .cuda_sim import _check_tensor
from .cuda_step import _f32, _kinds

# Launches of shard_scale_kernel and shard_finish_kernel; a run that must
# show it went through them reads these before and after.
SCALE_LAUNCHES = 0
FINISH_LAUNCHES = 0

# The longest horizon shard_finish_kernel takes at any filter window: a
# row's Σwε and its reflected series (at most 8T - 4 floats) in 48 KB of
# shared memory (csrc/shard_kernel.cu).
MAX_HORIZON = 1536


def unpack(packed: torch.Tensor):
    """(η (..., B), A (..., B, T, 2)) of a packed message, as views."""
    return packed[..., 0], packed[..., 1:].unflatten(-1, (-1, 2))


# ---- the rescale before the SUM ---------------------------------------------

def shard_scale_plain(m, m_loc, eta_loc, a_loc, lam: float):
    """Plain version of the rescale: m, m_loc, eta_loc (..., B), a_loc
    (..., B, T, 2).  Returns the packed message (..., B, 1 + 2T)."""
    scale = torch.exp((m - m_loc) / lam)
    return torch.cat([(eta_loc * scale)[..., None],
                      (a_loc * scale[..., None, None]).flatten(-2)], dim=-1)


def _scale_launch(m, m_loc, eta_loc, a_loc, lam):
    global SCALE_LAUNCHES
    from ._build import load_library

    f32, device, dtype = torch.float32, a_loc.device, a_loc.dtype
    m, m_loc, eta_loc, a_loc = map(_f32, (m, m_loc, eta_loc, a_loc))
    rows = tuple(m_loc.shape)
    if a_loc.dim() != len(rows) + 2 or a_loc.shape[-1] != 2:
        raise ValueError(f"a_loc must be (..., B, T, 2) over m_loc's "
                         f"{rows}, got {tuple(a_loc.shape)}")
    T = a_loc.shape[-2]
    for name, t, shape in (("m", m, rows), ("m_loc", m_loc, rows),
                           ("eta_loc", eta_loc, rows),
                           ("a_loc", a_loc, rows + (T, 2))):
        _check_tensor(name, t, shape, f32, device)
    n = m_loc.numel()
    if n < 1 or T < 1:
        raise ValueError(f"need a row and a horizon, got {n} rows, T={T}")
    packed = torch.empty(rows + (1 + 2 * T,), dtype=f32, device=device)
    inv_lam = float(np.float32(1.0) / np.float32(lam))
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_shard_scale_launch(
            m.data_ptr(), m_loc.data_ptr(), eta_loc.data_ptr(),
            a_loc.data_ptr(), packed.data_ptr(), n, T, inv_lam,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError("shard_scale_kernel launch failed: "
                           + lib.mppi_error_string(err).decode())
    SCALE_LAUNCHES += 1
    return packed.to(dtype)


def shard_scale(m, m_loc, eta_loc, a_loc, lam: float):
    """The rescale before the SUM (see the module docstring; arguments as
    :func:`shard_scale_plain`): CUDA tensors launch ``shard_scale_kernel``
    (contiguous; float32, float64 cast to it and the message back) or
    raise; CPU tensors take :func:`shard_scale_plain`."""
    if _kinds(m, m_loc, eta_loc, a_loc) == {"cpu"}:
        return shard_scale_plain(m, m_loc, eta_loc, a_loc, lam)
    return _scale_launch(m, m_loc, eta_loc, a_loc, lam)


# ---- the finish after the SUM -----------------------------------------------

def shard_finish_plain(cfg: MPPIConfig, packed, u_prev):
    """Plain version of the finish: the summed message ``packed`` (B, 1 +
    2T), u_prev (B, T, 2).  Returns u_seq = u_prev + the median filter of
    A/η, in u_prev's dtype."""
    # imported here: the solver imports the ops (utils/cuda_graphs.py)
    from ..mppi.solver import _median_update

    eta, a = unpack(packed)
    return _median_update(u_prev, (a / eta[:, None, None]).to(u_prev.dtype),
                          cfg)


def _finish_launch(cfg, packed, u_prev):
    global FINISH_LAUNCHES
    from ._build import load_library

    f32, device, dtype = torch.float32, u_prev.device, u_prev.dtype
    packed, u_prev = _f32(packed), _f32(u_prev)
    B, T = u_prev.shape[0], cfg.horizon
    if B < 1 or not 1 <= T <= MAX_HORIZON:
        raise ValueError(f"need a scenario and a horizon of 1 to "
                         f"{MAX_HORIZON}, got B={B}, T={T}")
    _check_tensor("packed", packed, (B, 1 + 2 * T), f32, device)
    _check_tensor("u_prev", u_prev, (B, T, 2), f32, device)
    u_seq = torch.empty_like(u_prev)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.mppi_shard_finish_launch(
            packed.data_ptr(), u_prev.data_ptr(), u_seq.data_ptr(), B, T,
            cfg.filter_window,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError("shard_finish_kernel launch failed: "
                           + lib.mppi_error_string(err).decode())
    FINISH_LAUNCHES += 1
    return u_seq.to(dtype)


def shard_finish(cfg: MPPIConfig, packed, u_prev):
    """The finish after the SUM (see the module docstring; arguments as
    :func:`shard_finish_plain`): CUDA tensors launch
    ``shard_finish_kernel`` (contiguous; float32, float64 cast to it and
    u_seq back to u_prev's dtype) or raise; CPU tensors take
    :func:`shard_finish_plain`."""
    if _kinds(packed, u_prev) == {"cpu"}:
        return shard_finish_plain(cfg, packed, u_prev)
    return _finish_launch(cfg, packed, u_prev)
