"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package is the reference.  Data crosses between the two packages as
NumPy arrays only, and noise is made with NumPy from fixed seeds, so both
sides see identical inputs.  ``tests/conftest.py`` pins JAX to the CPU with
x64 enabled before :func:`configs` imports it; nothing else here needs JAX,
so the card-only tests import this module on a machine without it.

:func:`replaying_capture` is the CUDA-graph stand-in of the tests of the
port's captured programs (``utils/cuda_graphs.py::run``: the per-call
entry points' and the per-step loops' chunks), :func:`counted_kernels`
the cuda backend's kernels counted on the CPU as on the card.
"""

import contextlib
import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch.config as pcfg
from mppi_robotarm_tpu_torch.mppi import solver as psolver
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step
from mppi_robotarm_tpu_torch.sim import loop as ploop
from mppi_robotarm_tpu_torch.utils import cuda_graphs

torch.set_num_threads(1)

SIGMA_SCALE = np.sqrt(20.0)     # the presets' Σ = 20·I


def eps_noise(seed: int, shape, dtype=np.float32) -> np.ndarray:
    """N(0, 20·I) noise of ``shape`` (..., 2) from a NumPy seed."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * SIGMA_SCALE).astype(dtype)


def configs(num_samples: int, horizon: int, **kw):
    """(JAX MPPIConfig, port MPPIConfig) with the same fields."""
    import mppi_robotarm_tpu.config as jcfg

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


# ---- CUDA graphs, replayed on the CPU ---------------------------------------

class StandInStream:
    """torch.cuda.Stream stand-in (the class is also the current stream)."""

    cuda_stream = 7

    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class StandInGraph:
    """torch.cuda.CUDAGraph stand-in: replays the program recorded while it
    was captured."""

    program = None

    def replay(self):
        self.program()


def _leaves(v):
    """The tensors of a nested result, in order (a packed result's flat
    buffers, ``cuda_graphs.Packed``)."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, cuda_graphs.Packed):
        return list(v.flats)
    if isinstance(v, tuple):
        return [t for x in v for t in _leaves(x)]
    return []


@pytest.fixture
def replaying_capture(monkeypatch):
    """torch.cuda's graph and stream calls answered on CPU tensors: a
    capture (``utils/cuda_graphs.py::capture``) runs its program once, as
    the real one records it, and keeps it; each replay runs the program
    again on the graph's buffers and writes what it returns into the
    tensors the capture returned, as a replay rewrites a graph's outputs
    in place, and leaves the launch counts as it found them, as a replay
    runs no wrapper (``cuda_graphs.replay`` adds what the capture
    recorded).  CPU tensors run as graphs (``cuda_graphs.DEVICES``), and
    each cache of graphs starts empty."""
    capture = cuda_graphs.capture

    def recording(program, *a, **k):
        c = capture(program, *a, **k)

        def again():
            counts = cuda_graphs.launch_counts()
            for dst, src in zip(_leaves(c.out), _leaves(program())):
                if dst is not src:
                    dst.copy_(src)
            for (mod, name), v in zip(cuda_graphs.COUNTERS, counts):
                setattr(mod, name, v)

        c.graph.program = again
        return c

    monkeypatch.setattr(cuda_graphs, "capture", recording)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", StandInStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: StandInStream)
    monkeypatch.setattr(cuda_graphs, "CAPTURE_STREAMS", {})
    monkeypatch.setattr(cuda_graphs, "DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(ploop, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(psolver, "_CALL_GRAPHS", OrderedDict())


@pytest.fixture
def counted_kernels(monkeypatch):
    """The cuda backend's kernels counted as their wrappers count a launch
    on the card (the plain versions count none): the step head one, the
    step tail one and one carried head when it carries the next step's
    head, the tail's statistics launched on their own one, and
    ``per_solve`` solve launches a call of the solve kernel's wrapper (1
    unless the returned function is called with another), as many of them
    on the compiled-width scan where ``cuda_sim.scan_width`` gives the
    wrapper's layout one."""
    solve, head = cuda_solve.solve_batched, cuda_step.step_head
    tail, stats = cuda_step.step_tail, cuda_step.step_stats

    def counted_head(*a, **k):
        cuda_step.HEAD_LAUNCHES += 1
        return head(*a, **k)

    def counted_tail(*a, **k):
        cuda_step.TAIL_LAUNCHES += 1
        cuda_step.CARRIED_HEADS += int(k.get("carry_head", False))
        return tail(*a, **k)

    def counted_stats(*a, **k):
        cuda_step.STATS_LAUNCHES += 1
        return stats(*a, **k)

    monkeypatch.setattr(cuda_step, "step_head", counted_head)
    monkeypatch.setattr(cuda_step, "step_tail", counted_tail)
    monkeypatch.setattr(cuda_step, "step_stats", counted_stats)

    def per_solve(n):
        def counted(arm, cfg, x0, *a, **k):
            eps = k.get("eps")
            K = k.get("k_local") or (cfg.num_samples if eps is None
                                     else eps.shape[1])
            lanes = cuda_solve.solve_layout(
                cfg, K, x0.shape[0], cuda_solve._sm_count(x0.device),
                k.get("tile"))[1]
            cuda_solve.LAUNCHES += n
            cuda_solve.COMPILED_SCANS += n * bool(
                cuda_sim.scan_width(cfg.search_idx_len, lanes))
            return solve(arm, cfg, x0, *a, **k)
        monkeypatch.setattr(cuda_solve, "solve_batched", counted)
    per_solve(1)
    return per_solve
