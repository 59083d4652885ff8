"""Headline benchmark: MPPI solves/s on one GPU at the north-star shape.

The counterpart of the JAX package's ``bench.py``, step for step:
``benchmark_preset()`` (K = 1024 samples, H = 50), the 8000-point
``synth_circle_path`` on the card, ``init_sim(seed=0)`` and a 4000-step
closed loop (solve, plant step, record) on each backend in bench.py's
order, one warm-up run and then the least of three wall times, each run
ending in ``torch.cuda.synchronize()``:

1. ``cuda-fused``: ``simulate_fused``, the whole loop in one launch of
   ``csrc/sim_kernel.cu`` (bench.py's ``pallas-fused``);
2. ``cuda``: ``simulate(backend="cuda")``, replayed CUDA graphs of the step
   head, the solve kernel and the step tail (bench.py's ``pallas``);
3. ``eager``: ``simulate(backend="eager")`` on the card, the vectorised
   PyTorch solve (bench.py's portable ``xla`` scan).

The fastest backend's solves/s is the headline.  When ``cuda-fused`` wins,
a 1000-step chain of it against the 4000-step one gives the device rate
(bench.py's two-length fit), printed beside the kernel's CUDA-event
µs/step.  Two gates hold the run to tracking: the on-path mean over the
first 1500 live steps (at least 1000 of them) under 42 mm, and the same
run of ``high_accuracy_preset()`` under 18 mm (bench.py:143-196).

    python -m mppi_robotarm_tpu_torch.bench [--first-only]

``--first-only`` stops after the first backend and skips the fit and the
high-accuracy run, as bench.py's does.  The last line of stdout is one
JSON object with bench.py's keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``on_path_mean_mm`` and, when measured,
``device_us_per_step`` and ``high_accuracy_on_path_mean_mm``); the rest goes
to stderr.  Unlike bench.py nothing falls back: a backend that raises, a
gate that fails, or a machine with no CUDA device ends the run with an
exception and a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from .config import benchmark_preset, high_accuracy_preset
from .device import resolve_device
from .sim.loop import init_sim, simulate, simulate_fused
from .sim.paths import synth_circle_path
from .tools.fused_timing import measure
from .tools.overhead import card
from .utils.metrics import ONPATH_FIRST, onpath_mean_mm

METRIC = "mppi_solves_per_s_per_chip_K1024_H50"
REFERENCE_SOLVES_PER_S = 1.0 / 6.96   # the reference extrapolated, BASELINE.md
PATH_POINTS = 8000
STEPS = 4000          # the timed chain
SHORT_STEPS = 1000    # the fit's second chain
ROUNDS = 3            # timed runs after the warm-up; the least counts
BACKENDS = ("cuda-fused", "cuda", "eager")
ONPATH_GATE_MM = 42.0     # bench.py:160
HA_GATE_MM = 18.0         # bench.py:175
MIN_LIVE = 1000           # live steps the gate window must hold


class GateError(RuntimeError):
    """A run that fails one of the benchmark's tracking gates."""


def runner(backend: str, arm, cfg, sim, ref, state0):
    """A function of n that runs n closed-loop steps of ``backend`` from
    ``state0`` and returns (final state, record)."""
    if backend == "cuda-fused":
        return lambda n: simulate_fused(arm, cfg, sim, ref, state0, n)
    if backend not in ("cuda", "eager"):
        raise ValueError(f"unknown backend {backend!r}")
    return lambda n: simulate(arm, cfg, sim, ref, state0, n, backend=backend)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(run, steps: int, device):
    """One warm-up run of ``steps`` steps, then ROUNDS timed ones; returns
    (the least wall time in seconds, the last run's output)."""
    out = run(steps)
    _sync(device)
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        out = run(steps)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times), out


def run_backends(arm, cfg, sim, ref, state0, steps: int,
                 first_only: bool = False, log=sys.stderr) -> dict:
    """Time each of BACKENDS in order (:func:`timed`); returns {name:
    (solves/s, (final state, record))}.  An exception of a backend
    propagates: nothing falls back to the next one."""
    results = {}
    for name in BACKENDS:
        seconds, out = timed(runner(name, arm, cfg, sim, ref, state0),
                             steps, ref.device)
        results[name] = (steps / seconds, out)
        print(f"# backend {name}: {steps / seconds:.1f} solves/s "
              f"({seconds:.4f} s for {steps} steps)", file=log)
        if first_only:
            break
    return results


def best_backend(results: dict) -> str:
    """The backend with the most solves/s."""
    return max(results, key=lambda b: results[b][0])


def device_fit(run, steps: int, t_long: float, device):
    """bench.py's two-length fit: the least of ROUNDS SHORT_STEPS-step
    runs against ``t_long`` seconds for ``steps`` steps; returns (device
    µs a step, the fixed seconds a call)."""
    t_short = timed(run, SHORT_STEPS, device)[0]
    slope = (t_long - t_short) / (steps - SHORT_STEPS)
    return 1e6 * slope, t_long - slope * steps


def gated_onpath_mm(rec, path_xy, gate_mm: float, label: str) -> float:
    """bench.py's gate: the on-path mean (mm) over the record's first
    ONPATH_FIRST live steps, which must number at least MIN_LIVE and
    average under ``gate_mm``; raises :class:`GateError` otherwise."""
    done = rec.done.cpu().numpy()
    live = int((~done).sum())
    if live < MIN_LIVE:
        raise GateError(f"{label}: {live} live steps, fewer than {MIN_LIVE}")
    mm = onpath_mean_mm(rec.ee.cpu().numpy(), done, path_xy, ONPATH_FIRST)
    if not mm < gate_mm:
        raise GateError(f"{label}: on-path mean {mm:.3f} mm over the first "
                        f"{min(live, ONPATH_FIRST)} live steps (gate "
                        f"{gate_mm} mm)")
    return mm


def bench_line(solves_per_s: float, on_path_mm: float, best: str,
               device_us=None, ha_mm=None) -> dict:
    """bench.py's JSON line (bench.py:198-208); ``device_us_per_step``
    only when ``cuda-fused`` won, as bench.py reports its fit."""
    if not (math.isfinite(solves_per_s) and solves_per_s > 0):
        raise GateError(f"solves/s {solves_per_s}")
    out = {
        "metric": METRIC,
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / REFERENCE_SOLVES_PER_S, 1),
        "on_path_mean_mm": round(on_path_mm, 2),
    }
    if device_us is not None and best == "cuda-fused":
        out["device_us_per_step"] = round(device_us, 2)
    if ha_mm is not None:
        out["high_accuracy_on_path_mean_mm"] = round(ha_mm, 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-only", action="store_true",
                    help="stop after the first backend; no fit and no "
                         "high-accuracy run")
    first_only = ap.parse_args(argv).first_only
    device = resolve_device(None)
    log = sys.stderr
    print(f"# device: {torch.cuda.get_device_name(device)}; {card()}",
          file=log)
    arm, cfg, sim = benchmark_preset()
    path = synth_circle_path(PATH_POINTS)
    path_xy = path[:, 0:2]
    ref = torch.as_tensor(path, device=device)
    state0 = init_sim(cfg, sim, seed=0, device=device)
    results = run_backends(arm, cfg, sim, ref, state0, STEPS,
                           first_only=first_only, log=log)
    best = best_backend(results)
    solves_per_s, (_, rec) = results[best]
    print(f"# best backend: {best}", file=log)

    device_us = None
    if best == "cuda-fused" and not first_only:
        device_us, fixed = device_fit(
            runner(best, arm, cfg, sim, ref, state0), STEPS,
            STEPS / solves_per_s, device)
        k1_us = measure(device, STEPS, default=True)[0]["us_per_step"]
        print(f"# device-only: {device_us:.2f} us/step ({1e6 / device_us:,.0f}"
              f" solves/s); fixed {fixed * 1e3:.2f} ms a call; sim_kernel "
              f"alone {k1_us:.2f} us/step (CUDA events, min of 3 "
              f"{STEPS}-step launches)", file=log)

    on_path = gated_onpath_mm(rec, path_xy, ONPATH_GATE_MM, best)
    print(f"# on-path mean {on_path:.3f} mm (gate {ONPATH_GATE_MM} mm)",
          file=log)
    ha_mm = None
    if not first_only:
        arm_h, cfg_h, sim_h = high_accuracy_preset()
        _, rec_h = simulate_fused(arm_h, cfg_h, sim_h, ref,
                                  init_sim(cfg_h, sim_h, seed=0,
                                           device=device), STEPS)
        ha_mm = gated_onpath_mm(rec_h, path_xy, HA_GATE_MM,
                                "high_accuracy_preset")
        print(f"# high_accuracy_preset: on-path mean {ha_mm:.3f} mm (gate "
              f"{HA_GATE_MM} mm)", file=log)
    print(json.dumps(bench_line(solves_per_s, on_path, best, device_us,
                                ha_mm)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
