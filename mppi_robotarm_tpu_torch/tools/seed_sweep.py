"""Closed-loop tracking quality across seeds, on the reference's own path.

The counterpart of ``tools/tpu_seed_sweep.py``: the reference
configuration (``circle_tracking_preset()``, K = 100, T = 30) for 1500
steps on the reference's ``xydq_circle.txt`` in float32, which the
checkout keeps in ``tests/data/reference_golden_run.npz``
(``sim/paths.py::reference_circle_path``; the tool raises when it is
missing), for several seeds.  Per seed it prints the on-path mean (the EE's
distance to the nearest path point) and the step-aligned RMS (against the
reference row of each step, ``utils/metrics.py::tracking_errors``) over
all steps, and the final waypoint; then the mean over the seeds beside the
reference's own executed run (10.76 mm), the spread, the gate it
suggests (max + 30 %) and the seeds over the JAX package's 45 mm bound for
this configuration (:data:`REPLAY_GATE_MM`).

``mode`` picks the loop:

* ``fused``: ``simulate_fused``, the whole loop in one launch of
  ``csrc/sim_kernel.cu`` (the JAX tool's ``fused``);
* ``cuda``: ``simulate(backend="cuda")``, the solve kernel between the
  step kernels as replayed CUDA graphs (its ``pallas``);
* ``eager``: ``simulate(backend="eager")``, the vectorised PyTorch solve
  (its ``xla``).

Every loop draws the port's Philox stream keyed by (seed, step).

    python -m mppi_robotarm_tpu_torch.tools.seed_sweep [n_seeds] [steps]
        [fused|cuda|eager] [K] [--device cuda|cpu]

On ``cuda`` (the default) it needs an NVIDIA GPU and exits non-zero
without one; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .. import config
from ..sim.loop import init_sim, simulate, simulate_fused
from ..sim.paths import reference_circle_path
from ..utils.metrics import tracking_errors
from .bench_gate_sweep import spread_lines
from .overhead import card

MODES = ("fused", "cuda", "eager")
REFERENCE_RUN_MM = 10.76     # the reference's executed run (PARITY_RUN.md)
# the JAX package's on-path bound for this configuration on this path
# (tests/test_reference_replay.py::test_f32_production_tracking_distribution,
# docs/PARITY_RUN.md); bench.py's 42 mm holds K = 1024, H = 50 on the
# 8000-point circle and does not apply here
REPLAY_GATE_MM = 45.0


def describe(device: torch.device) -> str:
    """The device a sweep ran on, with the card's power limit."""
    if device.type != "cuda":
        return "cpu (the kernels' plain versions)"
    return f"{torch.cuda.get_device_name(device)}; {card()}"


def reference_path() -> np.ndarray:
    """The reference's path as the JAX tool loads it, (2000, 4) float32."""
    return reference_circle_path().astype(np.float32)


def run(arm, cfg, sim, ref, seed: int, steps: int, mode: str):
    """``steps`` steps of ``mode``'s loop from ``init_sim(seed=seed)`` on
    ``ref``'s device; returns the record."""
    s0 = init_sim(cfg, sim, seed=seed, device=ref.device)
    if mode == "fused":
        return simulate_fused(arm, cfg, sim, ref, s0, steps)[1]
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return simulate(arm, cfg, sim, ref, s0, steps, backend=mode)[1]


def sweep(arm, cfg, sim, path, steps: int, seeds, mode: str, device,
          out=None):
    """Per seed: :func:`run`, then its on-path mean and step-aligned RMS in
    mm over all ``steps`` steps and its final waypoint, printed; returns
    (on-path means, RMS) lists."""
    ref = torch.as_tensor(path, device=device)
    onpath, aligned = [], []
    for seed in seeds:
        t0 = time.perf_counter()
        rec = run(arm, cfg, sim, ref, seed, steps, mode)
        st = tracking_errors(rec.ee.cpu().numpy(), path[1:steps + 1, 0:2],
                             full_path=path)
        onpath.append(st["onpath_mean_m"] * 1e3)
        aligned.append(st["ee_rms_m"] * 1e3)
        print(f"  seed {seed}: on-path mean {onpath[-1]:6.2f} mm | "
              f"step-aligned RMS {aligned[-1]:6.1f} mm | final wp "
              f"{int(rec.wp_idx[-1])}  ({time.perf_counter() - t0:.1f}s)",
              file=out, flush=True)
    return onpath, aligned


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", type=int, nargs="?", default=8)
    ap.add_argument("steps", type=int, nargs="?", default=1500)
    ap.add_argument("mode", nargs="?", default="fused", choices=MODES)
    ap.add_argument("K", type=int, nargs="?", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    path = reference_path()
    if a.device == "cuda" and not torch.cuda.is_available():
        print("seed_sweep: no CUDA device; pass --device cpu for the plain "
              "versions", file=sys.stderr)
        return 1
    device = torch.device(a.device, 0) if a.device == "cuda" else \
        torch.device("cpu")
    arm, cfg, sim = config.circle_tracking_preset()
    if a.K is not None:
        cfg = dataclasses.replace(cfg, num_samples=a.K)
    print(f"devices: {describe(device)}  seeds={a.n_seeds} steps={a.steps} "
          f"mode={a.mode} K={cfg.num_samples}")
    onpath, _ = sweep(arm, cfg, sim, path, a.steps, range(a.n_seeds),
                      a.mode, device)
    print(f"[{a.mode}] on-path mean over seeds: {np.mean(onpath):.2f} mm "
          f"(min {np.min(onpath):.2f}, max {np.max(onpath):.2f}); "
          f"reference's own executed run: {REFERENCE_RUN_MM} mm "
          f"(PARITY_RUN.md)")
    for line in spread_lines(onpath, REPLAY_GATE_MM, f"[{a.mode}] "):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
