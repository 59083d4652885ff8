"""Configuration of the PyTorch/CUDA port.

A copy of ``mppi_robotarm_tpu/config.py``: the same frozen dataclasses, the
same presets and the same JSON round-trip.  It is copied rather than
imported because importing anything from ``mppi_robotarm_tpu`` runs that
package's ``__init__``, which imports JAX, and the port never imports JAX.
``tests/test_torch_config.py`` holds the two copies equal field for field.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

Matrix2 = Tuple[Tuple[float, float], Tuple[float, float]]
Vec4 = Tuple[float, float, float, float]


@dataclasses.dataclass(frozen=True)
class ArmParams:
    """Physical constants of the 2-link planar arm (reference sys_params.py).

    The inertia matrix adds the raw link lengths l1/l2 to its diagonal terms
    (quirk Q1); plant and controller model share it.
    """

    Ts: float = 0.0025
    m1: float = 1.0
    m2: float = 1.0
    l1: float = 1.0
    l2: float = 1.0
    lc1: float = 0.5
    lc2: float = 0.5
    g: float = 9.81


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """MPPI solver hyperparameters (reference control.py:21-65, run.py:25-37)."""

    horizon: int = 30                      # T
    num_samples: int = 100                 # K
    exploration: float = 0.0               # exploration split (Q9)
    lam: float = 100.0                     # temperature λ
    alpha: float = 0.98                    # γ = λ(1−α)
    sigma: Matrix2 = ((20.0, 0.0), (0.0, 20.0))
    stage_cost_weight: Vec4 = (0.50, 0.50, 5.0, 5.0)
    terminal_cost_weight: Vec4 = (5.0, 5.0, 50.0, 50.0)
    delta_t: float = 0.006                 # controller-model dt = 2×plant dt (Q2)
    cost_scale: float = 10000.0            # stage/terminal ×10000 (Q7)
    dist_scale: float = 100.0              # waypoint metric ×100 (Q7)
    search_idx_len: int = 30               # waypoint window W (Q5)
    filter_window: int = 10                # median filter size (Q10)
    u_clamp: Optional[float] = None        # disabled input clamp (Q11)
    warm_start: Tuple[float, float] = (10.0, -2.0)
    # link lengths of the cost FK; the reference controller hardcodes 1.0
    l1: float = 1.0
    l2: float = 1.0

    @property
    def gamma(self) -> float:
        """γ = λ(1−α), control.py:45."""
        return self.lam * (1.0 - self.alpha)

    def validate(self) -> None:
        """Precondition checks mirroring control.py:157-159."""
        s = self.sigma
        if len(s) != 2 or any(len(row) != 2 for row in s):
            raise ValueError(
                "sigma must be a square matrix with the size of dim_u (=2)"
            )
        if self.horizon < 1 or self.num_samples < 1:
            raise ValueError("horizon and num_samples must be >= 1")
        if self.filter_window < 1:
            raise ValueError("filter_window must be >= 1")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Closed-loop simulator constants (reference run.py:9-16)."""

    dt: float = 0.003                     # plant integration step
    num_steps: int = 1500
    q0: Tuple[float, float] = (1.152198236517471885, -1.266101672070702344)
    dq0: Tuple[float, float] = (0.0, 0.0)
    disturbance: Tuple[float, float] = (0.0, 0.0)   # constant plant torque


def circle_tracking_preset() -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    """The exact run.py:25-37 configuration (K=100, T=30, circle path)."""
    return ArmParams(), MPPIConfig(), SimConfig()


def benchmark_preset() -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    """The benchmark shape: K=1024, H=50."""
    return (
        ArmParams(),
        dataclasses.replace(MPPIConfig(), horizon=50, num_samples=1024),
        SimConfig(),
    )


def high_accuracy_preset() -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    """K=1024, H=50 with the controller model's timestep matched to the
    plant (delta_t = 0.003 instead of the reference's 0.006, quirk Q2)."""
    return (
        ArmParams(),
        dataclasses.replace(MPPIConfig(), horizon=50, num_samples=1024,
                            delta_t=0.003),
        SimConfig(),
    )


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def config_to_json(arm: ArmParams, mppi: MPPIConfig, sim: SimConfig) -> str:
    return json.dumps(
        {
            "arm": dataclasses.asdict(arm),
            "mppi": dataclasses.asdict(mppi),
            "sim": dataclasses.asdict(sim),
        },
        indent=2,
    )


def config_from_json(text: str) -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    raw = json.loads(text)
    arm = ArmParams(**{k: _tuplify(v) for k, v in raw.get("arm", {}).items()})
    mppi = MPPIConfig(**{k: _tuplify(v) for k, v in raw.get("mppi", {}).items()})
    sim = SimConfig(**{k: _tuplify(v) for k, v in raw.get("sim", {}).items()})
    mppi.validate()
    return arm, mppi, sim
