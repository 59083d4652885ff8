"""Launch-overhead probes: wrappers, CUDA kernels, plain versions.

The ports of ``tools/tpu_overhead.py``'s two Pallas kernels, which do
almost nothing so that their time is the fixed cost of a launch:

* :func:`probe_scale` (P1, ``triv_kernel``): ``o = x · 1.000001``;
* :func:`probe_big` (P2, ``big_kernel``): the same ``o`` and a (100, 8, 128)
  float32 output of zeros, 400 KB, the cost of a large output, stored from
  one block an SM.

The probe shape is (8, 128) float32; any non-empty contiguous float32
tensor is taken.  CUDA tensors launch the kernels of
``csrc/probe_kernels.cu`` (built by ``ops/_build.py``, bound through
``ctypes``) or raise; CPU tensors take :func:`probe_scale_reference` and
:func:`probe_big_reference`.  Nothing falls back from one to the other.
``tools/overhead.py`` times them in chains, eagerly and as CUDA graphs.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .cuda_sim import _ptr
from .cuda_solve import _sm_count

SCALE = float(np.float32(1.000001))   # the kernels' float32 constant
BIG_SHAPE = (100, 8, 128)             # P2's output of zeros
MAX_ELEMENTS = 2 ** 31 - 1            # the kernels index with int

# Launches of the two kernels; a launch captured in a CUDA graph counts
# once, at capture, not at each replay.
SCALE_LAUNCHES = 0            # probe_scale_kernel
BIG_LAUNCHES = 0              # probe_big_kernel


def probe_scale_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``x · 1.000001`` in float32."""
    return x * SCALE


def probe_big_reference(x: torch.Tensor, big_shape=BIG_SHAPE):
    """Plain version of P2: (``x · 1.000001``, zeros of ``big_shape``,
    (100, 8, 128) at the probe shape)."""
    return x * SCALE, torch.zeros(big_shape, dtype=x.dtype, device=x.device)


def _check(x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if not 1 <= x.numel() <= MAX_ELEMENTS:
        raise ValueError(f"x must hold 1 to {MAX_ELEMENTS} elements, got "
                         f"{x.numel()}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on CUDA or CPU tensors, got "
                         f"{x.device}")


def _launch(c_fn: str, kernel: str, x: torch.Tensor, *args) -> None:
    """Call the C launcher ``c_fn`` with ``args`` on the current stream of
    ``x``'s device; raise with the CUDA error if the launch failed."""
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, c_fn)(*args, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.mppi_error_string(err).decode())


def probe_scale(x: torch.Tensor) -> torch.Tensor:
    """P1: ``x · 1.000001`` through ``probe_scale_kernel`` on a CUDA
    tensor, through :func:`probe_scale_reference` on a CPU one."""
    global SCALE_LAUNCHES
    _check(x)
    if x.device.type == "cpu":
        return probe_scale_reference(x)
    o = torch.empty_like(x)
    _launch("mppi_probe_scale_launch", "probe_scale_kernel", x, _ptr(x),
            _ptr(o), x.numel())
    SCALE_LAUNCHES += 1
    return o


def probe_big(x: torch.Tensor, big_shape=BIG_SHAPE):
    """P2: (``x · 1.000001``, zeros of ``big_shape``) through
    ``probe_big_kernel`` on a CUDA tensor, one block an SM, through
    :func:`probe_big_reference` on a CPU one.  ``big_shape`` must hold a
    multiple of 4 elements (the kernel stores 16-byte units)."""
    global BIG_LAUNCHES
    _check(x)
    n_big = math.prod(big_shape)
    if n_big % 4 or not 4 <= n_big <= MAX_ELEMENTS:
        raise ValueError(f"big_shape must hold a multiple of 4 elements, "
                         f"4 to {MAX_ELEMENTS}, got {tuple(big_shape)}")
    if x.device.type == "cpu":
        return probe_big_reference(x, big_shape)
    o = torch.empty_like(x)
    big = torch.empty(big_shape, dtype=torch.float32, device=x.device)
    _launch("mppi_probe_big_launch", "probe_big_kernel", x, _ptr(x), _ptr(o),
            x.numel(), _ptr(big), n_big, _sm_count(x.device))
    BIG_LAUNCHES += 1
    return o, big
