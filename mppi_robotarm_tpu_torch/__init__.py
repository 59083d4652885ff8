"""mppi_robotarm_tpu_torch — the PyTorch/CUDA port of mppi_robotarm_tpu.

The same MPPI path-tracking engine for the 2-link planar arm, in PyTorch,
with hand-written CUDA kernels for Hopper, built at first use: the whole
closed loop in one launch (``csrc/sim_kernel.cu``), a fleet of small-K
scenarios, up to four warps each (``csrc/fleet_kernel.cu``, behind
``simulate_fused_batch``), and the per-step loop's solve
(``csrc/solve_kernel.cu``) between its step head and tail
(``csrc/step_kernel.cu``) behind ``backend="cuda"``;
``csrc/probe_kernels.cu`` holds two launch-cost probes, which
``python -m mppi_robotarm_tpu_torch.tools.overhead`` times.
``python -m mppi_robotarm_tpu_torch.cli`` is the command-line interface.
State is made on the GPU unless ``device="cpu"`` is asked for.  The JAX
package stays the reference each part is checked against; this package
never imports JAX.
"""

from .config import (
    ArmParams,
    MPPIConfig,
    SimConfig,
    benchmark_preset,
    circle_tracking_preset,
    high_accuracy_preset,
    config_from_json,
    config_to_json,
)
from .mppi.solver import (
    MPPIState,
    SolveResult,
    VizResult,
    init_state,
    solve,
    solve_batched,
    viz_rollouts,
)
from .sim.loop import (
    SimRecord,
    SimState,
    init_sim,
    init_sim_batch,
    simulate,
    simulate_batch,
    simulate_fused,
    simulate_fused_batch,
    simulate_python,
)
from .sim.pathgen import generate_circle_path, save_path_file
from .sim.paths import (
    load_joint_log,
    load_ref_path,
    ref_path_from_joint_log,
    synth_circle_path,
)

__version__ = "0.1.0"

__all__ = [
    "ArmParams", "MPPIConfig", "SimConfig",
    "benchmark_preset", "circle_tracking_preset", "high_accuracy_preset",
    "config_from_json", "config_to_json",
    "MPPIState", "SolveResult", "VizResult", "init_state", "solve",
    "solve_batched", "viz_rollouts",
    "SimRecord", "SimState", "init_sim", "init_sim_batch", "simulate",
    "simulate_batch", "simulate_fused", "simulate_fused_batch",
    "simulate_python", "generate_circle_path", "save_path_file",
    "load_joint_log", "load_ref_path", "ref_path_from_joint_log",
    "synth_circle_path",
]
