"""The system under test, as the benchmark reaches it: the PyTorch and
CUDA port's public entries, its configuration types and its launch
counters.  The drivers import the port through this module alone; the
reference and the yardstick never import it.
"""

from __future__ import annotations

import json

import mppi_robotarm_tpu_torch as port
from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve, cuda_step


def configs(conf: dict):
    """The port's (ArmParams, MPPIConfig, SimConfig) of a configuration
    file's ``arm``, ``mppi`` and ``sim`` settings."""
    return port.config_from_json(json.dumps(
        {k: conf[k] for k in ("arm", "mppi", "sim")}))


def counters() -> dict:
    """The port's launch counts so far, by the kernel they count, and
    ``solve_partials``, the tile partials the solve kernel's combine has
    folded (``cuda_solve.PARTIALS``; left out where the port has no such
    count)."""
    out = {"sim_kernel": cuda_sim.LAUNCHES,
           "fleet_kernel": cuda_sim.FLEET_LAUNCHES,
           "solve_tile_kernel": cuda_solve.LAUNCHES,
           "step_head_kernel": cuda_step.HEAD_LAUNCHES,
           "step_tail_kernel": cuda_step.TAIL_LAUNCHES}
    if hasattr(cuda_solve, "PARTIALS"):
        out["solve_partials"] = cuda_solve.PARTIALS
    return out
