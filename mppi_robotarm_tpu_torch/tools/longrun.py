"""The whole-loop kernel against the per-step loop over a long horizon.

The counterpart of ``tools/tpu_fused_longrun.py``: it runs the fused
kernel (``simulate_fused``, csrc/sim_kernel.cu) and the per-step cuda loop
(``simulate(backend="cuda")``: the solve kernel between the step kernels)
on the same noise for N closed-loop steps, then reports the agreement
that chaos cannot fake:

* the waypoint schedule's exact-agreement prefix and match fraction;
* the |q| and |u| divergence envelope at steps 0, 9, 24, 49, 99 and the
  last, and the first steps where |Δq| exceeds 1e-6 and 1e-3 (the two
  loops sum in other orders, so the difference starts at ulp level and
  grows with the loop's Lyapunov rate);
* both runs' on-path mean over their live steps and step-aligned RMS
  (``utils/metrics.py::tracking_errors``).

Its set-up is the JAX tool's: ``circle_tracking_preset()`` (K = 100,
T = 30), ε = ``default_rng(0).normal(size=(steps, K, T, 2)) * sqrt(20)``
in float32, 150 steps by default, on the reference's own path,
``xydq_circle.txt`` in float32, which the checkout keeps in
``tests/data/reference_golden_run.npz`` (``sim/paths.py::
reference_circle_path``; the tool raises when that file is missing).
``--waypoints N`` runs on ``synth_circle_path(N)`` instead, the stand-in
``parallel/dryrun.py`` uses.  ``--prng`` drops the injected ε: both loops
draw the port's Philox stream, keyed by (seed, absolute step), so they see
the same noise.  ``--preset benchmark --waypoints N --revolutions R``
runs the long soak (``benchmark_preset``, K = 1024, H = 50, on an
R-revolution circle of N points; several N run one after another), and
each run's :func:`soak_checks` say whether it stayed finite, reached the
path's end and froze there, and give its on-path mean over bench.py's
window (the first 1500 live steps) and over the whole run.

    python -m mppi_robotarm_tpu_torch.tools.longrun [STEPS] [--prng]
        [--preset circle|benchmark] [--waypoints N [N ...]]
        [--revolutions R] [--device cuda|cpu]

On ``cuda`` (the default) it needs an NVIDIA GPU and exits non-zero
without one; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import config
from ..sim.loop import init_sim, simulate, simulate_fused
from ..sim.paths import reference_circle_path, synth_circle_path
from ..utils.metrics import ONPATH_FIRST, tracking_errors

MARKS = (0, 9, 24, 49, 99)        # steps whose envelope is printed, and last
ONPATH_CHUNK = 1024               # steps a nearest-point search takes at once


def problem(steps: int, prng: bool = False, preset: str = "circle",
            waypoints=None, revolutions: float = 1.0):
    """(arm, cfg, sim, path (N, 4) float32 NumPy, ε (steps, K, T, 2)
    float32 or None in PRNG mode) of a run; the path is the reference's
    circle, or with ``waypoints`` an R-revolution synthetic circle of that
    many points."""
    arm, cfg, sim = (config.circle_tracking_preset() if preset == "circle"
                     else config.benchmark_preset())
    path = (reference_circle_path().astype(np.float32) if waypoints is None
            else synth_circle_path(waypoints, revolutions=revolutions))
    eps = None if prng else eps_stream(steps, cfg)
    return arm, cfg, sim, path, eps


def eps_stream(steps: int, cfg) -> np.ndarray:
    """The JAX tool's injected noise: ``default_rng(0).normal(size=(steps,
    K, T, 2)) * sqrt(20)`` in float32."""
    return (np.random.default_rng(0).normal(
        size=(steps, cfg.num_samples, cfg.horizon, 2))
        * np.sqrt(20.0)).astype(np.float32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_fused(arm, cfg, sim, ref, steps: int, eps=None, seed: int = 0,
              chunks: int = 1):
    """``steps`` steps of ``simulate_fused`` from the preset's state at
    ``seed`` on ``ref``'s device, in ``chunks`` chained runs of equal
    length (the last takes the rest).  Returns (final state, record,
    seconds on the host clock, device synchronised)."""
    device = ref.device
    state = init_sim(cfg, sim, seed=seed, device=device)
    per = -(-steps // chunks)
    parts = []
    _sync(device)
    t0 = time.perf_counter()
    for start in range(0, steps, per):
        n = min(per, steps - start)
        state, rec = simulate_fused(arm, cfg, sim, ref, state, n,
                                    eps_per_step=None if eps is None
                                    else eps[start:start + n])
        parts.append(rec)
    _sync(device)
    seconds = time.perf_counter() - t0
    rec = type(parts[0])(*(torch.cat(f) for f in zip(*parts)))
    return state, rec, seconds


def run_per_step(arm, cfg, sim, ref, steps: int, eps=None, seed: int = 0):
    """``steps`` steps of ``simulate(backend="cuda")`` from the preset's
    state at ``seed`` on ``ref``'s device (replayed CUDA graphs on the card
    in PRNG mode, eager chunks with ε).  Returns (final state, record,
    seconds on the host clock, device synchronised)."""
    device = ref.device
    state = init_sim(cfg, sim, seed=seed, device=device)
    _sync(device)
    t0 = time.perf_counter()
    final, rec = simulate(arm, cfg, sim, ref, state, steps,
                          eps_per_step=eps, backend="cuda")
    _sync(device)
    return final, rec, time.perf_counter() - t0


def schedule_agreement(wp_a, wp_b):
    """(exact-agreement prefix in steps, match fraction) of two waypoint
    schedules."""
    eq = np.asarray(wp_a) == np.asarray(wp_b)
    prefix = len(eq) if eq.all() else int(np.argmin(eq))
    return prefix, float(eq.mean()) if len(eq) else 1.0


def envelope(rec_a, rec_b):
    """(max |Δq|, max |Δu|) over the joints, a step each, NumPy."""
    qd = (rec_a.q - rec_b.q).abs().amax(-1).double().cpu().numpy()
    ud = (rec_a.u - rec_b.u).abs().amax(-1).double().cpu().numpy()
    return qd, ud


def first_above(d, tol: float) -> int:
    """The first step where ``d`` exceeds ``tol`` (len(d) if none does)."""
    over = np.flatnonzero(np.asarray(d) > tol)
    return int(over[0]) if len(over) else len(d)


def onpath_mm(rec, path_xy, first=None):
    """(mean distance of the EE to the nearest path point over the live
    steps, or the ``first`` of them, in mm; those steps), the search in
    chunks of ONPATH_CHUNK steps on the record's device, from the
    coordinates' differences (the matrix-product form of ``cdist`` loses
    ~0.1 mm in float32)."""
    ee = rec.ee[~rec.done][:first]
    p = torch.as_tensor(np.asarray(path_xy), dtype=ee.dtype,
                        device=ee.device)
    total = 0.0
    for i in range(0, ee.shape[0], ONPATH_CHUNK):
        d = torch.cdist(ee[i:i + ONPATH_CHUNK], p,
                        compute_mode="donot_use_mm_for_euclid_dist")
        total += float(d.amin(1).double().sum())
    n = ee.shape[0]
    return (total / n * 1e3 if n else float("nan")), n


def tracking(rec, path_xy) -> dict:
    """On-path mean (mm) over the live steps, the live steps, and the
    step-aligned RMS (mm) of the EE against the reference row of its step
    over them."""
    mean, n = onpath_mm(rec, path_xy)
    live = (~rec.done).cpu().numpy()
    rms = (tracking_errors(rec.ee.cpu().numpy()[live],
                           rec.ref_xy.cpu().numpy()[live])["ee_rms_m"] * 1e3
           if n else float("nan"))
    return {"onpath_mean_mm": mean, "live_steps": n, "rms_mm": rms}


def compare(rec_f, rec_p, path_xy) -> dict:
    """The report of two runs of one problem (the fused kernel's first):
    schedule agreement, envelope at :data:`MARKS` and the last step, the
    first steps over 1e-6 and 1e-3, and each run's :func:`tracking`."""
    steps = rec_f.q.shape[0]
    wp_f, wp_p = rec_f.wp_idx.cpu().numpy(), rec_p.wp_idx.cpu().numpy()
    prefix, fraction = schedule_agreement(wp_f, wp_p)
    qd, ud = envelope(rec_f, rec_p)
    marks = sorted({s for s in MARKS if s < steps} | {steps - 1})
    return {
        "steps": steps, "wp_prefix": prefix, "wp_match_fraction": fraction,
        "wp_final": (int(wp_f[-1]), int(wp_p[-1])),
        "envelope": {s: (float(qd[s]), float(ud[s]), int(wp_f[s]),
                         int(wp_p[s])) for s in marks},
        "dq_first_above_1e-6": first_above(qd, 1e-6),
        "dq_first_above_1e-3": first_above(qd, 1e-3),
        "dq_max": float(qd.max()), "du_max": float(ud.max()),
        "fused": tracking(rec_f, path_xy),
        "per_step": tracking(rec_p, path_xy),
    }


def report_lines(rep: dict) -> list:
    """The JAX tool's printed report of :func:`compare`'s dict."""
    lines = [f"  step {s:5d}: |dq|={dq:.3e} |du|={du:.3e} wp {a:5d} vs {b:5d}"
             for s, (dq, du, a, b) in rep["envelope"].items()]
    lines.append(f"wp schedule: exact prefix {rep['wp_prefix']} steps; "
                 f"match fraction {rep['wp_match_fraction']:.3f}; final "
                 f"{rep['wp_final'][0]} vs {rep['wp_final'][1]}")
    lines.append(f"|dq|: <1e-6 for {rep['dq_first_above_1e-6']} steps; "
                 f"<1e-3 for {rep['dq_first_above_1e-3']} steps; max over "
                 f"run {rep['dq_max']:.3e} (|du| {rep['du_max']:.3e})")
    f, p = rep["fused"], rep["per_step"]
    lines.append(f"on-path EE mean: fused {f['onpath_mean_mm']:.2f} mm | "
                 f"per-step {p['onpath_mean_mm']:.2f} mm (live steps "
                 f"{f['live_steps']} | {p['live_steps']})")
    lines.append(f"step-aligned RMS: fused {f['rms_mm']:.1f} mm | per-step "
                 f"{p['rms_mm']:.1f} mm")
    return lines


def soak_checks(final, rec, path_xy) -> dict:
    """What a long run must show: every record finite; the live steps
    first, then, once the path's end is reached, every later row the last
    live state frozen (q, dq, waypoint index) with u and the cost lanes
    zeroed, as ``simulate`` states; the final step counter equal to the
    live steps (a run from step 0); and the on-path mean over the first
    ONPATH_FIRST live steps (bench.py's gate of 42 mm holds that window)
    and over all of them."""
    finite = all(bool(torch.isfinite(v).all()) for v in rec
                 if v.dtype.is_floating_point)
    done = rec.done
    live = int((~done).sum())
    steps = done.shape[0]
    ordered = bool((~done[:live]).all()) and bool(done[live:].all())
    frozen = ordered
    if ordered and 0 < live < steps:
        last = live - 1
        for f in ("q", "dq", "wp_idx"):
            v = getattr(rec, f)
            frozen = frozen and bool((v[live:] == v[last]).all())
        for f in ("u", "cost_min", "cost_mean", "ess", "weight_entropy"):
            frozen = frozen and bool((getattr(rec, f)[live:] == 0).all())
        frozen = frozen and bool(torch.equal(final.q, rec.q[-1]))
    return {"finite": finite, "live_steps": live,
            "reached_end": bool(done[-1]) and bool(final.done),
            "end_step": live if live < steps else None,
            "frozen": frozen, "counter": int(final.step) == live,
            "onpath_first_mm": onpath_mm(rec, path_xy, ONPATH_FIRST)[0],
            "onpath_mean_mm": onpath_mm(rec, path_xy)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=150)
    ap.add_argument("--prng", action="store_true",
                    help="the port's Philox stream instead of injected ε")
    ap.add_argument("--preset", choices=("circle", "benchmark"),
                    default="circle")
    ap.add_argument("--waypoints", type=int, nargs="+", default=[None],
                    help="a synthetic circle of N points instead of the "
                         "reference's path; several run one after another")
    ap.add_argument("--revolutions", type=float, default=1.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("longrun: no CUDA device; pass --device cpu for the plain "
              "versions", file=sys.stderr)
        return 1
    device = torch.device(a.device, 0) if a.device == "cuda" else \
        torch.device("cpu")
    where = "cpu"
    if device.type == "cuda":
        from .overhead import card
        where = f"{torch.cuda.get_device_name(0)}; {card()}"
    for waypoints in a.waypoints:
        arm, cfg, sim, path, eps = problem(a.steps, a.prng, a.preset,
                                           waypoints, a.revolutions)
        ref = torch.as_tensor(path, device=device)
        eps_t = None if eps is None else torch.as_tensor(eps, device=device)
        shape = ("the reference's xydq_circle.txt" if waypoints is None
                 else f"synth_circle_path({waypoints}), {a.revolutions:g} "
                      f"revolutions")
        print(f"device: {where}  steps={a.steps}  K={cfg.num_samples} "
              f"T={cfg.horizon}  path {shape}, {len(path)} points  noise "
              f"{'Philox' if eps is None else 'injected'}")
        final_f, rec_f, sec_f = run_fused(arm, cfg, sim, ref, a.steps, eps_t)
        print(f"fused: {sec_f:.2f} s")
        final_p, rec_p, sec_p = run_per_step(arm, cfg, sim, ref, a.steps,
                                             eps_t)
        print(f"per-step: {sec_p:.2f} s")
        for line in report_lines(compare(rec_f, rec_p, path[:, 0:2])):
            print(line)
        for label, final, rec in (("fused", final_f, rec_f),
                                  ("per-step", final_p, rec_p)):
            print(f"{label}: {soak_checks(final, rec, path[:, 0:2])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
