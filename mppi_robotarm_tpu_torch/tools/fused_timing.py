"""Time the port's closed-loop kernels on the GPU, once per launch setting,
and fingerprint their results.

Default mode, the fused closed loop (``sim_kernel``, K1) at
``benchmark_preset``: ``fused_sim_run`` for 4000 steps from
``init_sim(seed=0)`` on the 8000-point circle, as ``chip_smoke.py``'s phase
6 does, with CUDA events around each launch; every setting is timed once
per round, in turns, and the minimum over the rounds is kept. The settings
are the cluster sizes that the scenario's shape allows
(``cuda_sim.CLUSTER_SIZES``, or those given with ``--clusters``), or with
``--default`` the launch the package chooses by itself. For each it prints
µs/step and the SHA-256 of the records and u_final; then the on-path means
of ``simulate_fused`` at ``benchmark_preset`` and ``high_accuracy_preset``.

``--fleet``: the fleet of ``chip_smoke.py``'s phase 14 (4096 scenarios ×
K=128, T=30 on the 2000-point circle, 1000 steps; ``--samples`` replaces
K): ``fused_sim_run_batched`` at group 8 (``fleet_kernel``, K3) and group
1 (``sim_kernel``), µs per launch-step, min of 3 in turns, and the SHA-256
of each setting's records and u_final.

``--solve``: the device time of the solve kernels (``solve_tile_kernel``,
K2's tile pass, and ``solve_combine_kernel``) per ``solve_batched`` call,
by ``torch.profiler`` over 20 calls, on the layout the package picks: at
K=1024, H=50 for 1, 8 and 64 scenarios, at K=65536 (B=1) and at the
fleet's 4096 × K=128, T=30.

``--onpath-seeds S ...``: the per-step loop (``simulate(backend="cuda")``)
at ``benchmark_preset`` for 1500 steps from ``init_sim(seed=S)`` on the
8000-point circle: its on-path mean and the SHA-256 of its records, per
seed; ``--tile`` forces the solve's samples per block, which sets the
rounding of its cross-tile sums.

The script imports the package by name and never by a relative import, so
it also times another checkout's package, ``<tree>`` below (one that
predates the ``cluster`` keyword takes ``--default``; the other modes'
defaults need no newer keyword):

    python -m mppi_robotarm_tpu_torch.tools.fused_timing
    PYTHONPATH=<tree> python mppi_robotarm_tpu_torch/tools/fused_timing.py \
        --default
    python -m mppi_robotarm_tpu_torch.tools.fused_timing --fleet --samples 90
    python -m mppi_robotarm_tpu_torch.tools.fused_timing --onpath-seeds 0 1 \
        --tile 128

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
FLEET, FLEET_STEPS = 4096, 1000     # BASELINE config 4, chip_smoke phase 14
SOLVE_CALLS = 20      # solve calls per profiled window


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


def fleet_settings():
    """(label, keyword arguments) of each fleet launch to time: group 8
    (fleet_kernel), then group 1 (sim_kernel)."""
    return [("group=8", {"group": 8}), ("group=1", {"group": 1})]


def solve_shapes():
    """(label, B, K, T) of the solve shapes the main paths run: the
    per-step loop at benchmark_preset for 1, 8 and 64 scenarios, the
    large-K solve and the fleet's per-step solve."""
    return [("K=1024 H=50", 1, 1024, 50), ("K=1024 H=50", 8, 1024, 50),
            ("K=1024 H=50", 64, 1024, 50), ("K=65536 H=50", 1, 65536, 50),
            ("fleet 4096 x K=128 T=30", FLEET, 128, 30)]


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


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def fleet_inputs(device, samples=128):
    """The fleet of chip_smoke's phase 9 at K = ``samples``: (arm, cfg,
    sim, ref, states)."""
    arm, cfg, sim = m.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=samples, horizon=30)
    ref = torch.as_tensor(m.synth_circle_path(2000), device=device)
    q0 = (np.array([[1.1522, -1.2661]])
          + 0.01 * np.random.default_rng(9).normal(size=(FLEET, 2)))
    states = m.init_sim_batch(cfg, sim, np.arange(FLEET),
                              q0=q0.astype(np.float32), device=device)
    return arm, cfg, sim, ref, states


def measure_fleet(device, steps=FLEET_STEPS, samples=128):
    """One row per fleet setting (:func:`fleet_settings`): its label, the
    runs' ms, their minimum in µs per launch-step and the SHA-256 of the
    records and u_final."""
    arm, cfg, sim, ref, st = fleet_inputs(device, samples)
    args = (arm, cfg, sim, ref, st.q, st.dq, st.mppi.u_prev.contiguous(),
            st.mppi.wp_idx, st.seed, steps)
    rows = []
    for label, kw in fleet_settings():
        rec, ufin = cuda_sim.fused_sim_run_batched(*args, step0=st.step, **kw)
        rows.append({"setting": label, "kw": kw, "runs_ms": [],
                     "sha256": digest(rec, ufin)})
        del rec, ufin
    for _ in range(ROUNDS):
        for row in rows:
            row["runs_ms"].append(_events_ms(
                lambda: cuda_sim.fused_sim_run_batched(
                    *args, step0=st.step, **row["kw"])))
    for row in rows:
        row["us_per_step"] = min(row["runs_ms"]) / steps * 1e3
        del row["kw"]
    return rows


def solve_device_us(fn, calls=SOLVE_CALLS):
    """Device time per call of each solve kernel that ``fn`` launches
    (``torch.profiler`` over ``calls`` calls), by kernel name:
    {"solve_tile_kernel": µs, "solve_combine_kernel": µs}, each the mean
    time of a launch the profiler saw (a window can lose events at its
    edges).  A template instance's name counts as its kernel's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("solve_tile_kernel", "solve_combine_kernel"):
            if name in e.key:
                t = (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))
                out[name] = out.get(name, 0.0) + t / e.count
    if len(out) != 2:
        raise RuntimeError(f"the profiler saw no solve kernels: {out}")
    return out


def measure_solve(device):
    """One row per shape: device µs of the two solve kernels per call, min
    over ROUNDS profiled windows taken in turns."""
    from mppi_robotarm_tpu_torch.ops import cuda_solve

    arm, cfg0, _ = m.benchmark_preset()
    x1 = torch.tensor([[1.1522, -1.2661, 0.1, -0.2]], device=device)
    ref = torch.as_tensor(m.synth_circle_path(8000), device=device)
    rows = []
    for shape, B, K, T in solve_shapes():
        cfg = dataclasses.replace(cfg0, num_samples=K, horizon=T)
        W = cfg.search_idx_len
        x0 = x1.repeat(B, 1).contiguous()
        u = torch.tensor(cfg.warm_start, device=device).repeat(B, T, 1)
        idx = (7 * torch.arange(B, device=device) % 7000)[:, None] \
            + torch.arange(W, device=device)
        kw0 = dict(seed=torch.arange(B, device=device),
                   step=torch.zeros(B, dtype=torch.int64, device=device),
                   fuse_update=True, emit_eps=False)
        rows.append({"shape": shape, "B": B, "runs": [],
                     "call": (lambda c=cfg, x=x0, uu=u.contiguous(),
                              w=ref[idx].contiguous(), k=kw0:
                              cuda_solve.solve_batched(arm, c, x, uu, w,
                                                       **k))})
    for _ in range(ROUNDS):
        for row in rows:
            row["runs"].append(solve_device_us(row["call"]))
    for row in rows:
        del row["call"]
        for name in ("solve_tile_kernel", "solve_combine_kernel"):
            row[name + "_us"] = min(r[name] for r in row["runs"])
        row["runs"] = [{k: round(v, 3) for k, v in r.items()}
                       for r in row["runs"]]
    return rows


def steploop_onpath(device, seeds, tile=None, steps=ONPATH_STEPS):
    """Per seed: the on-path mean, mm, and the records' SHA-256 of the
    per-step loop at ``benchmark_preset`` from ``init_sim(seed)``, its
    solves on ``tile`` samples a block (None: the package's choice).

    The tile is forced through ``cuda_solve._plan``, which every tree of
    the port calls with the tile as its third argument."""
    from mppi_robotarm_tpu_torch.ops import cuda_solve

    plan = cuda_solve._plan
    if tile:
        cuda_solve._plan = lambda cfg, K, t, *a, **k: plan(cfg, K, t or tile,
                                                            *a, **k)
    try:
        arm, cfg, sim = m.benchmark_preset()
        path = m.synth_circle_path(8000)
        ref = torch.as_tensor(path, device=device)
        out = []
        for seed in seeds:
            _, rec = m.simulate(arm, cfg, sim, ref,
                                m.init_sim(cfg, sim, seed=seed,
                                           device=device), steps,
                                backend="cuda")
            out.append({"seed": seed, "tile": tile or "default",
                        "onpath_mm": live_onpath_mm(rec, path[:, 0:2])[0],
                        "sha256": digest(*rec)})
        return out
    finally:
        cuda_solve._plan = plan


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
                    help="replace benchmark_preset's K (timing only), or "
                    "the fleet's with --fleet")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--fleet", action="store_true",
                    help="time the fleet: fleet_kernel against sim_kernel")
    ap.add_argument("--solve", action="store_true",
                    help="device time of the solve kernels")
    ap.add_argument("--onpath-seeds", type=int, nargs="+",
                    help="on-path mean of the per-step loop for each seed")
    ap.add_argument("--tile", type=int,
                    help="--onpath-seeds: the solve's samples per block")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_timing: no CUDA device; it times the GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = card()
    if a.onpath_seeds:
        rows = steploop_onpath(device, a.onpath_seeds, a.tile)
        for row in rows:
            print(f"{a.label} [{smi}] per-step loop seed {row['seed']} tile "
                  f"{row['tile']}: on-path {row['onpath_mm']:.3f} mm over "
                  f"{ONPATH_STEPS} steps; records sha256 {row['sha256']}")
        print(json.dumps({"label": a.label, "card": smi, "onpath": rows}))
        return 0
    if a.fleet:
        samples = a.samples or 128
        rows = measure_fleet(device, samples=samples)
        for row in rows:
            print(f"{a.label} [{smi}] fleet {FLEET} x K={samples} T=30 "
                  f"{row['setting']}: {row['us_per_step']:.2f} us/launch-step"
                  f" over {FLEET_STEPS} steps, runs "
                  f"{[round(t, 2) for t in row['runs_ms']]} ms; records+"
                  f"u_final sha256 {row['sha256']}")
        same = len({row["sha256"] for row in rows}) == 1
        print(json.dumps({"label": a.label, "card": smi, "fleet": rows,
                          "same_bits": same}))
        return 0 if same else 1
    if a.solve:
        rows = measure_solve(device)
        for row in rows:
            print(f"{a.label} [{smi}] solve {row['shape']} B={row['B']}: "
                  f"solve_tile_kernel {row['solve_tile_kernel_us']:.2f} us + "
                  f"solve_combine_kernel {row['solve_combine_kernel_us']:.2f}"
                  f" us device time a call (min of {ROUNDS} windows of "
                  f"{SOLVE_CALLS})")
        print(json.dumps({"label": a.label, "card": smi, "solve": rows}))
        return 0
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
