"""Time the fused closed loop (``sim_kernel``) at ``benchmark_preset`` on the
GPU, once per launch setting, and fingerprint its records.

Runs ``fused_sim_run`` for 4000 steps from ``init_sim(seed=0)`` on the
8000-point circle, as ``chip_smoke.py``'s phase 6 does, with CUDA events
around each launch; every setting is timed once per round, in turns, and
the minimum over the rounds is kept. The settings are the cluster sizes
that the scenario's shape allows (``cuda_sim.CLUSTER_SIZES``, or those
given with ``--clusters``), or with ``--default`` the launch the package
chooses by itself. For each it prints µs/step and the SHA-256 of the
records and u_final; then the on-path means of ``simulate_fused`` at
``benchmark_preset`` and ``high_accuracy_preset``.

The script imports the package by name and never by a relative import, so
it also times another checkout's package, ``<tree>`` below (one that
predates the ``cluster`` keyword takes ``--default``):

    python -m mppi_robotarm_tpu_torch.tools.fused_timing
    PYTHONPATH=<tree> python mppi_robotarm_tpu_torch/tools/fused_timing.py \
        --default

Without an NVIDIA GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

import mppi_robotarm_tpu_torch as m
from mppi_robotarm_tpu_torch.ops import cuda_sim

STEPS = 4000
ROUNDS = 3
ONPATH_STEPS = 1500   # bench.py:143-150: the first 1500 live steps


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def settings(num_samples: int, clusters=None, default: bool = False):
    """(label, keyword arguments) of each launch setting to time: the
    package's own choice alone with ``default``, else one per cluster size
    that fits the shape (of ``clusters``, if given)."""
    if default:
        return [("default", {})]
    nwarp = cuda_sim.sim_threads(num_samples) // 32
    return [(f"cluster={c}", {"cluster": c})
            for c in sorted(clusters or cuda_sim.CLUSTER_SIZES)
            if nwarp % c == 0]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def live_onpath_mm(rec, path_xy):
    """(mean EE distance to the nearest path point over the first
    ONPATH_STEPS live steps in mm, the number of those steps) of a
    SimRecord (bench.py:143-150)."""
    ee = rec.ee.cpu().numpy()[~rec.done.cpu().numpy()][:ONPATH_STEPS]
    d = [np.linalg.norm(ee[i:i + 256, None] - path_xy[None], axis=-1)
         .min(axis=1) for i in range(0, len(ee), 256)]
    mean = float(np.concatenate(d).mean() * 1e3) if d else float("nan")
    return mean, len(ee)


def measure(device, steps=STEPS, clusters=None, horizon=None, samples=None,
            default=False):
    """One row per launch setting: its label, the runs' ms, their minimum
    in µs/step and the SHA-256 of the records and u_final."""
    arm, cfg, sim = m.benchmark_preset()
    cfg = dataclasses.replace(cfg, horizon=horizon or cfg.horizon,
                              num_samples=samples or cfg.num_samples)
    ref = torch.as_tensor(m.synth_circle_path(8000), device=device)
    s0 = m.init_sim(cfg, sim, seed=0, device=device)
    args = (arm, cfg, sim, ref, s0.q, s0.dq, s0.mppi.u_prev, s0.mppi.wp_idx,
            s0.seed, steps)
    rows = []
    for label, kw in settings(cfg.num_samples, clusters, default):
        rec, ufin = cuda_sim.fused_sim_run(*args, **kw)      # warm-up
        rows.append({"setting": label, "kw": kw, "runs_ms": [],
                     "sha256": digest(rec, ufin)})
    for _ in range(ROUNDS):
        for row in rows:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            cuda_sim.fused_sim_run(*args, **row["kw"])
            stop.record()
            torch.cuda.synchronize()
            row["runs_ms"].append(start.elapsed_time(stop))
    for row in rows:
        row["us_per_step"] = min(row["runs_ms"]) / steps * 1e3
        del row["kw"]
    return rows


def onpath_means(device, steps=STEPS):
    """On-path mean, mm, of ``simulate_fused`` at ``benchmark_preset`` and
    ``high_accuracy_preset`` from ``init_sim(seed=0)``."""
    path = m.synth_circle_path(8000)
    ref = torch.as_tensor(path, device=device)
    means = {}
    for name, preset in (("benchmark_preset", m.benchmark_preset),
                         ("high_accuracy_preset", m.high_accuracy_preset)):
        a, c, s = preset()
        _, rec = m.simulate_fused(a, c, s, ref,
                                  m.init_sim(c, s, seed=0, device=device),
                                  steps)
        means[name] = live_onpath_mm(rec, path[:, 0:2])[0]
    return means


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--clusters", type=int, nargs="*",
                    help="cluster sizes to time (default: all that fit)")
    ap.add_argument("--default", action="store_true",
                    help="time only the launch the package chooses")
    ap.add_argument("--horizon", type=int,
                    help="replace benchmark_preset's horizon (timing only)")
    ap.add_argument("--samples", type=int,
                    help="replace benchmark_preset's K (timing only)")
    ap.add_argument("--label", default="", help="printed on every line")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_timing: no CUDA device; it times the GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = card()
    rows = measure(device, a.steps, a.clusters, a.horizon, a.samples,
                   a.default)
    for row in rows:
        print(f"{a.label} [{smi}] sim_kernel {row['setting']}: "
              f"{row['us_per_step']:.2f} us/step over {a.steps} steps, runs "
              f"{[round(t, 2) for t in row['runs_ms']]} ms; records+u_final "
              f"sha256 {row['sha256']}")
    same = len({row["sha256"] for row in rows}) == 1
    means = onpath_means(device, a.steps)
    print(f"{a.label} every setting gives the same bits: {same}; on-path "
          + ", ".join(f"{k} {v:.3f} mm" for k, v in means.items()))
    print(json.dumps({"label": a.label, "card": smi, "rows": rows,
                      "onpath_mm": means, "same_bits": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
