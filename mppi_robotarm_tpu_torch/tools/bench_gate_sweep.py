"""The benchmark's gates over seeds, at the benchmark's exact program.

The counterpart of ``tools/tpu_bench_gate_sweep.py``: for each seed it runs
what ``python -m mppi_robotarm_tpu_torch.bench`` gates, ``simulate_fused``
(``csrc/sim_kernel.cu``) at ``benchmark_preset()`` (K = 1024, H = 50) on
the 8000-point ``synth_circle_path`` for 4000 steps, and prints the
on-path mean over the first 1500 live steps (``utils/metrics.py::
onpath_mean_mm``) and the final waypoint; then the spread over the seeds,
the gate such a spread suggests (its max + 30 %) and how many seeds lie
over the benchmark's gate.  With ``high_accuracy`` the same sweep runs
``high_accuracy_preset()`` (the controller's Δt matched to the plant's)
against its 18 mm gate.  A seed over a gate is reported, not raised.

    python -m mppi_robotarm_tpu_torch.tools.bench_gate_sweep [n_seeds]
        [bench|high_accuracy]

It needs an NVIDIA GPU and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import bench, config
from ..sim.loop import init_sim, simulate_fused
from ..sim.paths import synth_circle_path
from ..utils.metrics import ONPATH_FIRST, onpath_mean_mm
from .overhead import card

GATES = {"bench": bench.ONPATH_GATE_MM, "high_accuracy": bench.HA_GATE_MM}


def spread_lines(values, gate_mm: float, label: str = "") -> list:
    """The JAX tools' closing lines over per-seed on-path means (mm): the
    spread, the gate a spread suggests (max + 30 %, rounded up) and the
    seeds over ``gate_mm``."""
    v = np.asarray(values, dtype=np.float64)
    over = [i for i, x in enumerate(v) if not x < gate_mm]
    return [f"{label}spread over {len(v)} seeds: min {v.min():.1f} / mean "
            f"{v.mean():.1f} / max {v.max():.1f} mm",
            f"{label}suggested gate (max + 30% margin): "
            f"{np.ceil(v.max() * 1.3):.0f} mm",
            f"{label}gate {gate_mm:g} mm: {len(over)} of {len(v)} seeds over "
            f"it{'' if not over else ' (seeds ' + str(over) + ')'}"]


def sweep(arm, cfg, sim, path, steps: int, seeds, device,
          out=None) -> list:
    """Per seed: ``simulate_fused`` of ``steps`` steps from
    ``init_sim(seed=seed)`` on ``path`` (N, 4) NumPy; prints its line and
    returns the on-path means (mm) over the first ONPATH_FIRST live
    steps."""
    ref = torch.as_tensor(path, device=device)
    errs = []
    for seed in seeds:
        t0 = time.perf_counter()
        _, rec = simulate_fused(arm, cfg, sim, ref,
                                init_sim(cfg, sim, seed=seed, device=device),
                                steps)
        e = onpath_mean_mm(rec.ee.cpu().numpy(), rec.done.cpu().numpy(),
                           path[:, 0:2], ONPATH_FIRST)
        errs.append(e)
        print(f"  seed {seed}: on-path mean {e:6.2f} mm  final-wp "
              f"{int(rec.wp_idx[-1])}  ({time.perf_counter() - t0:.1f}s)",
              file=out, flush=True)
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", type=int, nargs="?", default=8)
    ap.add_argument("preset", nargs="?", default="bench",
                    choices=sorted(GATES))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_gate_sweep: no CUDA device; the fused kernel needs one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    arm, cfg, sim = (config.high_accuracy_preset()
                     if a.preset == "high_accuracy"
                     else config.benchmark_preset())
    print(f"devices: {torch.cuda.get_device_name(device)}; {card()}  "
          f"K={cfg.num_samples} "
          f"H={cfg.horizon} path={bench.PATH_POINTS}pt steps={bench.STEPS} "
          f"gate-window=first {ONPATH_FIRST} live")
    errs = sweep(arm, cfg, sim, synth_circle_path(bench.PATH_POINTS),
                 bench.STEPS, range(a.n_seeds), device)
    for line in spread_lines(errs, GATES[a.preset]):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
