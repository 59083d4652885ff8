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

``--solve``: per ``solve_batched`` call (PRNG mode, fused update, no noise
output) on the layout the package picks, at K=1024, H=50 for 1, 8 and 64
scenarios, at K=100, T=30 for 8, at K=65536 (B=1) and at the fleet's 4096
× K=128, T=30: the device time of each solve kernel it launches
(``torch.profiler`` over 20 calls; any kernel whose name holds
``solve_``, so a tree that still launches a separate combine is timed
whole), the CUDA-event time per call over 20 calls, eager and as one
replayed CUDA graph of the 20 calls (no host time between launches), min
of 3 in turns;
then the SHA-256 of (out, S, m, η) of one call at lam = 3e5 (tens of
samples weigh) in each noise mode, PRNG and injected noise drawn on the
device from a fixed ``torch.Generator`` seed.

``--probes``: the device time per call of P1 and P2 (``probe_scale``,
``probe_big``) and of ``torch.mul`` on P1's input (``torch.profiler`` over
100 calls, min of 3, in turns), and whether P2's zeros and both outputs
equal their plain versions bit for bit, P1's also at 1027 elements (no
vector width divides it) and on a view 4 bytes past a 16-byte boundary.

``--steploop``: the per-step loop (``simulate_batch(backend="cuda")``)
as replayed CUDA graphs of S steps, for each S of ``--chunks`` (default 1,
8, 16, 32, 64, 256; ``sim/loop.py::_GRAPH_STEPS`` set to each in turn), against
the uncaptured chunked loop (``sim/loop.py::_step_loop`` within
``utils/cuda_graphs.py::uncaptured()``): at
``benchmark_preset`` (B=1) over 1000 steps and on the fleet of
``chip_smoke.py``'s phase 9 over 50 steps, each µs/step by CUDA events,
min of 3 in turns, the SHA-256 of records and final state, each S's
capture-and-instantiate seconds, and at ``benchmark_preset`` the wall
seconds of a 4000-step run from an empty graph cache (capture included;
min of 3, in turns).

``--split``: where one step of the per-step loop spends its device time,
at ``benchmark_preset`` (B=1) and on the fleet of ``chip_smoke.py``'s
phase 9: a profiled run of the loop as replayed CUDA graphs, by kernel
name (launches and device µs a step), then each piece of the step
(:func:`split_pieces`: the step kernels' plain versions, the torch code
they replaced, cut by source; the solve kernel; the step kernels, the tail
also carrying the next head) profiled alone on the same state.
``--tail-layouts L:G ...`` also times the step tail carrying the head in
each of these layouts on the same state (L logical lanes a lane, G
scenarios a block; the warps, the cap and the cluster follow from the
shape and the build, :func:`tail_layout_of`; a layout the kernel does not
take at a shape is left out there).

``--onpath-seeds S ...``: the per-step loop (``simulate(backend="cuda")``)
at ``benchmark_preset`` for 1500 steps from ``init_sim(seed=S)`` on the
8000-point circle: its on-path mean and the SHA-256 of its records (and of
each field), per seed; ``--tile`` forces the solve's samples per block,
which sets the rounding of its cross-tile sums; ``--out DIR`` writes each
seed's records to ``DIR/seed<S>.npz``, and ``--compare-records A B``
(no card needed) holds two such directories field by field: bit for bit,
or the largest absolute and relative difference.

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
    python -m mppi_robotarm_tpu_torch.tools.fused_timing --steploop
    python -m mppi_robotarm_tpu_torch.tools.fused_timing --split
    python -m mppi_robotarm_tpu_torch.tools.fused_timing --split \
        --tail-layouts 2:1 4:8
    PYTHONPATH=<tree> python mppi_robotarm_tpu_torch/tools/fused_timing.py \
        --solve --label parent

Without an NVIDIA GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

import mppi_robotarm_tpu_torch as m
from mppi_robotarm_tpu_torch.ops import cuda_sim
from mppi_robotarm_tpu_torch.utils import cuda_graphs
from mppi_robotarm_tpu_torch.utils.metrics import (
    ONPATH_FIRST as ONPATH_STEPS,
    onpath_mean_mm,
)

STEPS = 4000
ROUNDS = 3
FLEET, FLEET_STEPS = 4096, 1000     # BASELINE config 4, chip_smoke phase 14
SOLVE_CALLS = 20      # solve calls per profiled window
SOLVE_LAM = 3e5       # --solve's fingerprints: tens of samples carry weight
PROBE_CALLS = 100     # --probes: calls per profiled window
PROFILE_TRIES = 3     # profiled windows before one that saw nothing counts
STEPLOOP_STEPS = 1000  # --steploop at benchmark_preset
STEPLOOP_CHUNKS = (1, 8, 16, 32, 64, 256)   # --steploop: graph lengths
FLEET_LOOP_STEPS = 50  # --steploop on the fleet, chip_smoke's phase 9
SPLIT_CALLS = 20      # --split: calls of each piece per profiled window


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
    reference config's (one tile a scenario) for 8, the large-K solve and
    the fleet's per-step solve."""
    return [("K=1024 H=50", 1, 1024, 50), ("K=1024 H=50", 8, 1024, 50),
            ("K=1024 H=50", 64, 1024, 50), ("K=100 T=30", 8, 100, 30),
            ("K=65536 H=50", 1, 65536, 50),
            ("fleet 4096 x K=128 T=30", FLEET, 128, 30)]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def live_onpath_mm(rec, path_xy):
    """(mean EE distance to the nearest path point over the first
    ONPATH_STEPS live steps in mm, the number of those steps) of a
    SimRecord (``utils/metrics.py::onpath_mean_mm``, bench.py:143-150)."""
    done = rec.done.cpu().numpy()
    mean = onpath_mean_mm(rec.ee.cpu().numpy(), done, path_xy, ONPATH_STEPS)
    return mean, min(int((~done).sum()), ONPATH_STEPS)


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


def device_total(event) -> float:
    """An averaged profiler event's own device time, µs (the attribute's
    name changed across torch releases)."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0.0))


def profiled_us(fn, calls, keep=lambda key: True, tries=PROFILE_TRIES):
    """Mean device µs of a launch, by profiler event key, of each kernel
    that ``calls`` calls of ``fn`` launch and whose key ``keep`` accepts
    (``torch.profiler``).  A window can lose events at its edges, so the
    mean of the launches it kept is taken, not their total.  A window has
    also been seen to come back with no device event at all, so one that
    kept none is profiled again, ``tries`` windows in all.  Empty if every
    window came back empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key: device_total(e) / e.count for e in prof.key_averages()
               if device_total(e) > 0 and keep(e.key)}
        if out:
            return out
    return {}


def kernel_device_us(fn, calls, match):
    """Device time per call of each kernel that ``fn`` launches whose name
    holds ``match`` (:func:`profiled_us` over ``calls`` calls), by kernel
    name, µs.  A template instance's name counts as its kernel's.  Raises
    if no window saw one."""
    out = {}
    for key, us in profiled_us(fn, calls, lambda k: match in k).items():
        name = re.search(r"\w*" + match + r"\w*", key).group(0)
        out[name] = out.get(name, 0.0) + us
    if not out:
        raise RuntimeError(f"the profiler saw no {match} kernel in "
                           f"{PROFILE_TRIES} windows")
    return out


def solve_device_us(fn, calls=SOLVE_CALLS):
    """Device µs per call of each solve kernel ``fn`` launches
    (:func:`kernel_device_us`): {"solve_tile_kernel": µs}, and
    "solve_combine_kernel" where a tree launches it apart."""
    return kernel_device_us(fn, calls, "solve_")


def solve_inputs(device, B, K, T, lam=None):
    """(arm, cfg, x0, u, window, PRNG keywords) of ``--solve``'s call at one
    shape: benchmark_preset at K and T (and ``lam``), B copies of one
    state and the warm start, windows at staggered indices of the
    8000-point circle, seeds 0..B-1 at step 0."""
    arm, cfg, _ = m.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=K, horizon=T,
                              lam=lam or cfg.lam)
    W = cfg.search_idx_len
    ref = torch.as_tensor(m.synth_circle_path(8000), device=device)
    x0 = torch.tensor([[1.1522, -1.2661, 0.1, -0.2]],
                      device=device).repeat(B, 1).contiguous()
    u = torch.tensor(cfg.warm_start, device=device).repeat(B, T, 1)
    idx = (7 * torch.arange(B, device=device) % 7000)[:, None] \
        + torch.arange(W, device=device)
    kw = dict(seed=torch.arange(B, device=device),
              step=torch.zeros(B, dtype=torch.int64, device=device),
              fuse_update=True, emit_eps=False)
    return arm, cfg, x0, u.contiguous(), ref[idx].contiguous(), kw


def solve_digests(device, B, K, T):
    """{noise mode: SHA-256 of (out, S, m, η)} of one solve at lam =
    SOLVE_LAM: PRNG mode, and injected N(0, 20·I) noise from a
    ``torch.Generator`` seeded with B + K + T on the device."""
    from mppi_robotarm_tpu_torch.ops import cuda_solve

    arm, cfg, x0, u, win, kw = solve_inputs(device, B, K, T, SOLVE_LAM)
    gen = torch.Generator(device=device).manual_seed(B + K + T)
    eps = torch.randn((B, K, T, 2), generator=gen, device=device) * 20 ** 0.5
    out = {}
    for noise, nkw in (("prng", kw),
                       ("eps", dict(eps=eps, fuse_update=True))):
        w, s, _, (mm, eta) = cuda_solve.solve_batched(arm, cfg, x0, u, win,
                                                      **nkw)
        out[noise] = digest(w, s, mm, eta)
    return out


def _graph_of(calls):
    """A CUDA graph of ``calls`` (already warmed up), captured once."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        calls()
    return graph


def measure_solve(device):
    """One row per shape (:func:`solve_shapes`): device µs of each solve
    kernel per call and their sum, and CUDA-event µs per call over
    SOLVE_CALLS calls, eager and replayed as one graph, each the min over
    ROUNDS taken in turns; then the fingerprints of
    :func:`solve_digests`."""
    from mppi_robotarm_tpu_torch.ops import cuda_solve

    rows = []
    for shape, B, K, T in solve_shapes():
        arm, cfg, x0, u, win, kw = solve_inputs(device, B, K, T)
        rows.append({"shape": shape, "B": B, "runs": [], "event_us_runs": [],
                     "graph_us_runs": [],
                     "call": (lambda c=cfg, x=x0, uu=u, w=win, k=kw:
                              cuda_solve.solve_batched(arm, c, x, uu, w,
                                                       **k))})
    for _ in range(ROUNDS):
        for row in rows:
            calls = lambda: [row["call"]() for _ in range(SOLVE_CALLS)]
            row["runs"].append(solve_device_us(row["call"]))
            row["event_us_runs"].append(_events_ms(calls) * 1e3
                                        / SOLVE_CALLS)
            graph = row.get("graph") or row.setdefault("graph",
                                                       _graph_of(calls))
            row["graph_us_runs"].append(_events_ms(graph.replay) * 1e3
                                        / SOLVE_CALLS)
    for row, (_, B, K, T) in zip(rows, solve_shapes()):
        del row["call"], row["graph"]
        names = sorted({k for r in row["runs"] for k in r})
        row["kernels_us"] = {k: min(r.get(k, 0.0) for r in row["runs"])
                             for k in names}
        row["device_us"] = min(sum(r.values()) for r in row["runs"])
        row["event_us"] = min(row["event_us_runs"])
        row["graph_us"] = min(row["graph_us_runs"])
        row["runs"] = [{k: round(v, 3) for k, v in r.items()}
                       for r in row["runs"]]
        row["sha256"] = solve_digests(device, B, K, T)
    return rows


def measure_probes(device, calls=PROBE_CALLS):
    """Device µs per call of P1 and P2 at the probe shape (min of ROUNDS
    profiled windows, in turns), and whether both equal their plain
    versions bit for bit."""
    from mppi_robotarm_tpu_torch.ops import cuda_probe

    rng = np.random.default_rng(15)
    x = torch.as_tensor(rng.normal(size=(8, 128)).astype(np.float32),
                        device=device)
    o1 = cuda_probe.probe_scale(x)
    o2, big = cuda_probe.probe_big(x)
    want, zeros = cuda_probe.probe_big_reference(x)
    same = (torch.equal(o1, want) and torch.equal(o2, want)
            and torch.equal(big, zeros))
    odd = torch.as_tensor(rng.normal(size=1028).astype(np.float32),
                          device=device)
    for v in (odd[:1027], odd[1:]):     # ragged; 4 bytes past 16
        same = same and torch.equal(cuda_probe.probe_scale(v),
                                    cuda_probe.probe_scale_reference(v))
    fns = {"probe_scale_kernel": lambda: cuda_probe.probe_scale(x),
           "probe_big_kernel": lambda: cuda_probe.probe_big(x),
           "torch.mul": lambda: torch.mul(x, cuda_probe.SCALE)}
    runs = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            runs[name].append(sum(
                profiled_us(fn, calls).values() if name == "torch.mul"
                else kernel_device_us(fn, calls, "probe_").values()))
    return {"us": {k: min(v) for k, v in runs.items()},
            "runs": {k: [round(t, 4) for t in v] for k, v in runs.items()},
            "same_bits": same}


def _run_digest(final, rec) -> str:
    return digest(*rec, final.step, final.q, final.dq, *final.mppi,
                  final.done)


def measure_steploop(device, chunks=STEPLOOP_CHUNKS):
    """Rows of the per-step loop's timing (see ``--steploop``): for each
    case (``benchmark_preset`` over STEPLOOP_STEPS steps, the fleet over
    FLEET_LOOP_STEPS), the eager chunked loop and a graph loop per chunk
    length S, in turns, ROUNDS rounds: µs/step (min), the runs' ms, the
    SHA-256 of records and final state, and per S the capture seconds of
    each graph it captured (by steps)."""
    from mppi_robotarm_tpu_torch.sim import loop

    arm, cfg, sim = m.benchmark_preset()
    ref = torch.as_tensor(m.synth_circle_path(8000), device=device)
    one = loop._as_batch(m.init_sim(cfg, sim, seed=0, device=device))
    cases = [("benchmark_preset", (arm, cfg, sim, ref, one), STEPLOOP_STEPS),
             (f"fleet {FLEET} x K=128 T=30", fleet_inputs(device),
              FLEET_LOOP_STEPS)]
    keep = loop._GRAPH_STEPS
    out = []
    try:
        for case, args, steps in cases:
            rows = [{"case": case, "setting": "eager", "S": keep,
                     "runs_ms": []}]
            rows += [{"case": case, "setting": f"graph S={S}", "S": S,
                      "runs_ms": []} for S in chunks]
            loop._GRAPHS.clear()
            for row in rows:
                loop._GRAPH_STEPS = row["S"]
                before = set(loop._GRAPHS)
                # a run that runs each chunk length uncaptured once, then
                # one that captures what the first did not
                for _ in range(2):
                    with _chunks_as(row):
                        row["sha256"] = _run_digest(*loop._step_loop(
                            *args, steps))
                row["capture_s"] = loop._capture_seconds(before)
            for _ in range(ROUNDS):
                for row in rows:
                    loop._GRAPH_STEPS = row["S"]
                    with _chunks_as(row):
                        row["runs_ms"].append(_events_ms(
                            lambda: loop._step_loop(*args, steps)))
            for row in rows:
                row["steps"] = steps
                row["us_per_step"] = min(row["runs_ms"]) / steps * 1e3
            if case == "benchmark_preset":
                # a 4000-step run from an empty cache, capture included,
                # min of ROUNDS in turns
                for _ in range(ROUNDS):
                    for row in rows[1:]:
                        loop._GRAPH_STEPS = row["S"]
                        loop._GRAPHS.clear()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        loop._step_loop(*args, STEPS)
                        torch.cuda.synchronize()
                        row.setdefault("run_4000_runs_s", []).append(
                            time.perf_counter() - t0)
                for row in rows[1:]:
                    row["run_4000_s"] = min(row["run_4000_runs_s"])
            loop._GRAPHS.clear()
            out += rows
    finally:
        loop._GRAPH_STEPS = keep
    return out


def profile_calls(fn, calls, tries=PROFILE_TRIES) -> dict:
    """{profiler key: (launches a call, device µs a call)} of every device
    event (kernel, memcpy, memset) that ``calls`` calls of ``fn`` make, from
    one ``torch.profiler`` window after one unprofiled call; a window that
    saw nothing is profiled again, ``tries`` windows in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key: (e.count / calls, device_total(e) / calls)
               for e in prof.key_averages() if device_total(e) > 0}
        if out:
            return out
    return {}


def split_cases(device):
    """(case, (arm, cfg, sim, ref, batched state), steps a profiled window)
    of ``--split``: benchmark_preset at B=1 on the 8000-point circle and
    the 4096-scenario fleet of ``chip_smoke.py``'s phase 9."""
    from mppi_robotarm_tpu_torch.sim import loop

    arm, cfg, sim = m.benchmark_preset()
    ref = torch.as_tensor(m.synth_circle_path(8000), device=device)
    one = loop._as_batch(m.init_sim(cfg, sim, seed=0, device=device))
    return [("benchmark_preset B=1", (arm, cfg, sim, ref, one), 64),
            (f"fleet {FLEET} x K=128 T=30", fleet_inputs(device), 16)]


def split_pieces(arm, cfg, sim, ref, st, tail_layouts=()):
    """One step's work cut by source, as (label, source, callable) on the
    batched state ``st``: the torch code the step kernels replaced, as
    their plain versions run it (the step head's waypoint advance, the
    plant alone, the step tail without and with its record row), the solve
    kernel, and the two step kernels, on the same state, the tail also
    carrying the next head: in the package's layout, then in each of
    ``tail_layouts`` (specs of :func:`tail_layout_of`) the kernel takes
    at this shape."""
    from mppi_robotarm_tpu_torch.mppi import solver
    from mppi_robotarm_tpu_torch.ops import cuda_step
    from mppi_robotarm_tpu_torch.sim import loop

    head = lambda fn: fn(cfg, ref, st.q, st.dq, st.mppi.wp_idx)
    x0, wp, path_end, window = head(cuda_step.step_head_plain)

    def solve():
        return solver._solve_kernels(arm, cfg, x0, st.mppi.u_prev, window,
                                     st.seed, None, st.step, False)

    u_seq, s, _ = solve()
    state = (*loop._state_tensors(st)[:5], st.done)
    row = tuple(r[0] for r in loop._row_buffers(1, st, ref))
    tail = lambda fn, r: fn(arm, cfg, sim, ref, *state, wp, path_end, u_seq,
                            s, st.step, r)
    plain = "ops/cuda_step.py::step_tail_plain"
    carried = "ops/cuda_step.py::step_tail(carry_head=True)"
    forced = []
    for spec in tail_layouts:
        lay = tail_layout_of(spec, cfg.num_samples, st.q.shape[0])
        if lay is not None:
            forced.append((
                f"step tail kernel carrying the head, layout {spec} "
                f"{tuple(lay)}", "ops/cuda_step.py::_tail_launch(layout=)",
                lambda lay=lay: cuda_step._tail_launch(
                    arm, cfg, sim, ref, state, wp, path_end, u_seq, s,
                    st.step, row, carry_head=True, layout=lay)))
    return [
        ("waypoint advance", "ops/cuda_step.py::step_head_plain",
         lambda: head(cuda_step.step_head_plain)),
        ("solve kernel (K2)", "mppi/solver.py::_solve_kernels", solve),
        ("plant", "ops/cuda_step.py::plant_step",
         lambda: cuda_step.plant_step(arm, sim, st.q, st.dq, u_seq[:, 1])),
        ("shift, plant, freeze", plain + " without a row",
         lambda: tail(cuda_step.step_tail_plain, None)),
        ("shift, plant, freeze, record row", plain + " with the row",
         lambda: tail(cuda_step.step_tail_plain, row)),
        ("step tail kernel carrying the head", carried,
         lambda: cuda_step.step_tail(
             arm, cfg, sim, ref, *state, wp, path_end, u_seq, s, st.step,
             row, carry_head=True)),
        *forced,
        ("step head kernel", "ops/cuda_step.py::step_head",
         lambda: head(cuda_step.step_head)),
        ("step tail kernel", "ops/cuda_step.py::step_tail",
         lambda: tail(cuda_step.step_tail, row)),
    ]


def tail_layout_of(spec: str, K: int, B: int):
    """The step tail's layout "L:G" at K samples and B scenarios: L
    logical lanes a lane on the build that has them (so ceil(n / 32 / L)
    statistics warps, spread over a cluster of ``cuda_step.TAIL_CLUSTER``
    CTAs on the clustered build), at most G scenarios a block; None where
    the kernel does not take it."""
    from mppi_robotarm_tpu_torch.ops import cuda_step

    lanes, group = map(int, spec.split(":"))
    cap = dict(cuda_step.TAIL_BUILT).get(lanes)
    if cap is None:
        return None
    C = (cuda_step.TAIL_CLUSTER if (lanes, cap) == cuda_step.CLUSTER_BUILD
         else 1)
    n = cuda_step.step_tail_threads(K)
    lay = cuda_step.TailLayout(-(-(n // 32) // (lanes * C)), lanes,
                               min(group, B), cap, C)
    return lay if cuda_step.tail_layout_fits(lay, K) else None


def _chunks_as(row):
    """The block of a ``--steploop`` row: uncaptured for the eager row."""
    return (cuda_graphs.uncaptured() if row["setting"] == "eager"
            else contextlib.nullcontext())


def measure_split(device, calls=SPLIT_CALLS, tail_layouts=()):
    """Per case of :func:`split_cases`: the device time and launches of
    one step of the per-step loop as replayed CUDA graphs of
    ``_GRAPH_STEPS`` (a profiled run of ``steps`` steps from a state 32
    steps into the run, by kernel name; the run's own copies out of the
    graphs' buffers and its record are in it), then of each of
    :func:`split_pieces` on that state (``calls`` calls each), the step
    tail also in each of ``tail_layouts``."""
    from mppi_robotarm_tpu_torch.ops import cuda_step
    from mppi_robotarm_tpu_torch.sim import loop

    out = []
    for case, (arm, cfg, sim, ref, st0), steps in split_cases(device):
        st, _ = loop._step_loop(arm, cfg, sim, ref, st0, 32)
        st = st._replace(seed=torch.as_tensor(st0.seed, device=device))
        graph = profile_calls(
            lambda: loop._step_loop(arm, cfg, sim, ref, st, steps), 1)
        by_kernel = {k: (n / steps, us / steps) for k, (n, us)
                     in graph.items()}
        pieces = []
        for label, source, fn in split_pieces(arm, cfg, sim, ref, st,
                                              tail_layouts):
            got = profile_calls(fn, calls)
            pieces.append({"piece": label, "source": source,
                           "launches": sum(n for n, _ in got.values()),
                           "us": sum(us for _, us in got.values()),
                           "kernels": sorted(got)})
        layout = list(cuda_step._tail_layout_on(
            cfg.num_samples, st0.q.shape[0], device))
        out.append({"case": case, "layout": layout, "steps": steps,
                    "graph_by_kernel":
                    by_kernel, "graph_launches": sum(
                        n for n, _ in by_kernel.values()),
                    "graph_us": sum(us for _, us in by_kernel.values()),
                    "pieces": pieces})
    return out


def steploop_onpath(device, seeds, tile=None, steps=ONPATH_STEPS, out=None):
    """Per seed: the on-path mean, mm, and the records' SHA-256 of the
    per-step loop at ``benchmark_preset`` from ``init_sim(seed)``, its
    solves on ``tile`` samples a block (None: the package's choice), and
    each record field's SHA-256; with ``out``, each seed's records go to
    ``out/seed<S>.npz``.

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
        rows = []
        for seed in seeds:
            _, rec = m.simulate(arm, cfg, sim, ref,
                                m.init_sim(cfg, sim, seed=seed,
                                           device=device), steps,
                                backend="cuda")
            rows.append({"seed": seed, "tile": tile or "default",
                         "onpath_mm": live_onpath_mm(rec, path[:, 0:2])[0],
                         "sha256": digest(*rec),
                         "fields": {f: digest(v)[:16] for f, v in
                                    zip(rec._fields, rec)}})
            if out:
                os.makedirs(out, exist_ok=True)
                np.savez(os.path.join(out, f"seed{seed}.npz"),
                         **{f: v.cpu().numpy()
                            for f, v in zip(rec._fields, rec)})
        return rows
    finally:
        cuda_solve._plan = plan


def compare_records(dir_a: str, dir_b: str) -> list:
    """Per ``seed<S>.npz`` in both directories (``--onpath-seeds --out``)
    and per record field: equal bit for bit or not, the largest absolute
    and relative difference."""
    rows = []
    for name in sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b))):
        with np.load(os.path.join(dir_a, name)) as a, \
                np.load(os.path.join(dir_b, name)) as b:
            for f in a.files:
                x, y = a[f].astype(np.float64), b[f].astype(np.float64)
                d = np.abs(x - y)
                rows.append({"file": name, "field": f,
                             "equal": bool(np.array_equal(a[f], b[f])),
                             "max_abs": float(d.max()),
                             "max_rel": float((d / np.maximum(
                                 np.abs(y), 1e-30)).max())})
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
                    help="replace benchmark_preset's K (timing only), or "
                    "the fleet's with --fleet")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--fleet", action="store_true",
                    help="time the fleet: fleet_kernel against sim_kernel")
    ap.add_argument("--solve", action="store_true",
                    help="device and event time of the solve, SHA-256")
    ap.add_argument("--probes", action="store_true",
                    help="device time of the probes P1 and P2")
    ap.add_argument("--steploop", action="store_true",
                    help="the per-step loop: eager against CUDA graphs")
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=list(STEPLOOP_CHUNKS),
                    help="--steploop: the graphs' lengths in steps")
    ap.add_argument("--split", action="store_true",
                    help="a per-step loop step's device time by kernel "
                    "and by source")
    ap.add_argument("--tail-layouts", nargs="+", metavar="L:G",
                    help="--split: also time the step tail in each layout")
    ap.add_argument("--onpath-seeds", type=int, nargs="+",
                    help="on-path mean of the per-step loop for each seed")
    ap.add_argument("--tile", type=int,
                    help="--onpath-seeds: the solve's samples per block")
    ap.add_argument("--out", help="--onpath-seeds: write each seed's "
                    "records to OUT/seed<S>.npz")
    ap.add_argument("--compare-records", nargs=2, metavar=("A", "B"),
                    help="compare two --out directories field by field "
                    "(needs no card)")
    a = ap.parse_args(argv)
    if a.compare_records:
        rows = compare_records(*a.compare_records)
        for r in rows:
            print(f"{a.label} {r['file']} {r['field']}: "
                  + ("equal bit for bit" if r["equal"] else
                     f"differs: max |d| {r['max_abs']:.6g}, max relative "
                     f"{r['max_rel']:.6g}"))
        print(json.dumps({"label": a.label, "compare": rows}))
        return 0
    if not torch.cuda.is_available():
        print("fused_timing: no CUDA device; it times the GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = card()
    if a.onpath_seeds:
        rows = steploop_onpath(device, a.onpath_seeds, a.tile, out=a.out)
        for row in rows:
            print(f"{a.label} [{smi}] per-step loop seed {row['seed']} tile "
                  f"{row['tile']}: on-path {row['onpath_mm']:.3f} mm over "
                  f"{ONPATH_STEPS} steps; records sha256 {row['sha256']}")
        print(json.dumps({"label": a.label, "card": smi, "onpath": rows}))
        return 0
    if a.split:
        rows = measure_split(device, tail_layouts=a.tail_layouts or ())
        for row in rows:
            print(f"{a.label} [{smi}] split {row['case']} tail layout "
                  f"{row['layout']}: the graph loop "
                  f"{row['graph_us']:.2f} us device time and "
                  f"{row['graph_launches']:.2f} launches a step (a profiled "
                  f"{row['steps']}-step run)")
            for key, (n, us) in sorted(row["graph_by_kernel"].items(),
                                       key=lambda kv: -kv[1][1]):
                print(f"{a.label}   graph kernel {n:7.3f} a step "
                      f"{us:9.3f} us  {key[:110]}")
            for p in row["pieces"]:
                print(f"{a.label}   piece {p['piece']} ({p['source']}): "
                      f"{p['launches']:.2f} launches, {p['us']:.3f} us")
        print(json.dumps({"label": a.label, "card": smi, "split": rows}))
        return 0
    if a.steploop:
        rows = measure_steploop(device, a.chunks)
        for row in rows:
            cap = ", ".join(f"{n} steps {t:.3f} s" for n, t in
                            sorted(row["capture_s"].items()))
            print(f"{a.label} [{smi}] per-step loop {row['case']} "
                  f"{row['setting']}: {row['us_per_step']:.2f} us/step over "
                  f"{row['steps']} steps, runs "
                  f"{[round(t, 2) for t in row['runs_ms']]} ms"
                  + (f"; capture {cap}" if cap else "")
                  + (f"; a {STEPS}-step run from an empty cache "
                     f"{row['run_4000_s']:.3f} s (runs "
                     f"{[round(t, 3) for t in row['run_4000_runs_s']]})"
                     if "run_4000_s" in row else "")
                  + f"; records+final sha256 {row['sha256']}")
        same = all(len({r["sha256"] for r in rows if r["case"] == c}) == 1
                   for c in {r["case"] for r in rows})
        print(json.dumps({"label": a.label, "card": smi, "steploop": rows,
                          "same_bits": same}))
        return 0 if same else 1
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
            kern = " + ".join(f"{k} {v:.2f}" for k, v in
                              row["kernels_us"].items())
            print(f"{a.label} [{smi}] solve {row['shape']} B={row['B']}: "
                  f"{kern} us device time a call (min of {ROUNDS} windows "
                  f"of {SOLVE_CALLS}; sum {row['device_us']:.2f}); "
                  f"{row['event_us']:.2f} us a call by CUDA events, "
                  f"{row['graph_us']:.2f} replayed as a graph; "
                  f"(out, S, m, eta) sha256 prng {row['sha256']['prng']} "
                  f"eps {row['sha256']['eps']}")
        print(json.dumps({"label": a.label, "card": smi, "solve": rows}))
        return 0
    if a.probes:
        got = measure_probes(device)
        print(f"{a.label} [{smi}] probes: device time a call (min of "
              f"{ROUNDS} windows of {PROBE_CALLS}): "
              + ", ".join(f"{k} {v:.4f} us" for k, v in got["us"].items())
              + f"; outputs == plain versions bitwise: {got['same_bits']}")
        print(json.dumps({"label": a.label, "card": smi, "probes": got}))
        return 0 if got["same_bits"] else 1
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
