"""The eager backend's per-step loop on the GPU: replayed CUDA graphs
against the uncaptured loop, their bits and their times.

``simulate``/``simulate_batch(backend="eager")`` step all scenarios in
batched PyTorch and, on the card, replay each chunk of
``sim/loop.py::_EAGER_GRAPH_STEPS`` steps as one CUDA graph;
``sim/loop.py::_step_loop(..., backend="eager")`` within
``utils/cuda_graphs.py::uncaptured()`` runs the same chunks uncaptured.
Default mode, ``chip_smoke.py``'s phase 27:

* bits (:func:`check_bits`): the graphs against the uncaptured loop,
  records and final state, at ``benchmark_preset`` in float32 over
  BITS_STEPS steps and at K=128, T=30 in float64 over SMALL_STEPS steps;
  a BATCH-scenario batch at K=128, T=30 over SMALL_STEPS steps against
  each of its scenarios run alone; each the largest |difference| by
  field (0 where bitwise);
* timing (:func:`time_loop`) at ``benchmark_preset``: µs/step of the
  graphs and of the uncaptured loop over TIME_STEPS steps, CUDA events,
  min of ROUNDS in turns; the host's µs a step to enqueue the graphs
  (wall time of a run before its synchronisation); the device events a
  step and the device-busy µs/step from a profiled window of
  PROFILE_STEPS steps of the graphs, the idle share 1 − busy /
  unprofiled µs/step; each chunk's capture and instantiation seconds;
* the fleet (:func:`fleet_rate`): 4096 × K=128, T=30 (chip_smoke's phase
  9) for FLEET_STEPS steps as graphs, scenario-steps/s (min of ROUNDS,
  after a run that captures), and the device events of a profiled step.

``--chunks S ...`` (:func:`chunk_sweep`): for each chunk length S in
turns, at ``benchmark_preset``: every graph's capture seconds, µs/step
over ``--steps`` steps (min of ROUNDS), the projected 4000-step run
(captures + 4000 × µs/step), and the SHA-256 of records and final state,
which must be the uncaptured loop's for every S.

    python -m mppi_robotarm_tpu_torch.tools.eager_loop
    python -m mppi_robotarm_tpu_torch.tools.eager_loop --chunks 1 4 16

Without an NVIDIA GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import torch

import mppi_robotarm_tpu_torch as m
from mppi_robotarm_tpu_torch.sim import loop
from mppi_robotarm_tpu_torch.utils import cuda_graphs
from mppi_robotarm_tpu_torch.tools.fused_timing import (
    FLEET, PROFILE_TRIES, ROUNDS, STEPS, _events_ms, _run_digest,
    device_total, fleet_inputs)
from mppi_robotarm_tpu_torch.tools.overhead import card

BITS_STEPS = 200      # benchmark_preset, float32: graphs == uncaptured
SMALL_STEPS = 50      # K=128, T=30: float64, and the batch against alone
BATCH = 64            # scenarios of the batch held to their runs alone
TIME_STEPS = 50       # steps a timed run, graphs and uncaptured
PROFILE_STEPS = 10    # steps of the profiled window
FLEET_STEPS = 20      # the 4096-scenario fleet
SWEEP_STEPS = 200     # --chunks: steps a timed run


def run(args, steps: int, graphs: bool = True):
    """``steps`` eager steps of the batched state in ``args`` (arm, cfg,
    sim, ref, states), as graphs or uncaptured: (final state, record)."""
    with contextlib.nullcontext() if graphs else cuda_graphs.uncaptured():
        return loop._step_loop(*args, steps, backend="eager")


def bench_inputs(device, dtype=torch.float32, samples=None, horizon=None):
    """``benchmark_preset`` (K and T replaceable) on the 8000-point circle
    from ``init_sim(seed=0)``, a batch of one: (arm, cfg, sim, ref,
    states)."""
    arm, cfg, sim = m.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=samples or cfg.num_samples,
                              horizon=horizon or cfg.horizon)
    ref = torch.as_tensor(m.synth_circle_path(8000), dtype=dtype,
                          device=device)
    st = m.init_sim(cfg, sim, seed=0, dtype=dtype, device=device)
    return arm, cfg, sim, ref, loop._as_batch(st)


def differences(a, b) -> dict:
    """{field: largest |a - b|} over two (final state, record) runs'
    record fields and final state (``final_<name>``); 0.0 where bitwise,
    NaN where they differ only in NaNs."""
    (fa, ra), (fb, rb) = a, b
    pairs = list(zip(ra._fields, ra, rb)) + list(zip(
        ("final_step", "final_q", "final_dq", "final_u_prev",
         "final_wp_idx", "final_done"),
        (fa.step, fa.q, fa.dq, *fa.mppi, fa.done),
        (fb.step, fb.q, fb.dq, *fb.mppi, fb.done)))
    out = {}
    for name, x, y in pairs:
        if torch.equal(x, y):
            out[name] = 0.0
        else:
            out[name] = float((x.double() - y.double()).abs().max())
    return out


def check_bits(device) -> list:
    """[(label, {field: max |d|})] of the three comparisons (module
    docstring); every value is 0.0 where the runs are bitwise equal."""
    out = []
    args = bench_inputs(device)
    out.append((f"benchmark_preset float32, {BITS_STEPS} steps: graphs "
                f"against the uncaptured loop",
                differences(run(args, BITS_STEPS),
                            run(args, BITS_STEPS, graphs=False))))
    args = bench_inputs(device, torch.float64, 128, 30)
    out.append((f"K=128 T=30 float64, {SMALL_STEPS} steps: graphs against "
                f"the uncaptured loop",
                differences(run(args, SMALL_STEPS),
                            run(args, SMALL_STEPS, graphs=False))))
    arm, cfg, sim, ref, states = fleet_inputs(device)
    states = _rows(states, 0, BATCH)
    final, rec = run((arm, cfg, sim, ref, states), SMALL_STEPS)
    worst: dict = {}
    for b in range(BATCH):
        alone = run((arm, cfg, sim, ref, _rows(states, b, b + 1)),
                    SMALL_STEPS)
        mine = (_rows(final, b, b + 1),
                m.SimRecord(*(f[:, b:b + 1] for f in rec)))
        for k, v in differences(mine, alone).items():
            worst[k] = max(worst.get(k, 0.0), v)
    out.append((f"{BATCH}-scenario batch at K=128 T=30, {SMALL_STEPS} "
                f"steps: each scenario against its run alone (graphs)",
                worst))
    return out


def _rows(states, start: int, stop: int):
    """Scenarios ``start`` to ``stop`` of a batched state."""
    return loop._as_state(tuple(v[start:stop]
                                for v in loop._state_tensors(states)))


def time_loop(device, steps=TIME_STEPS) -> dict:
    """The eager loop's rates at ``benchmark_preset`` (module docstring):
    µs/step of the graphs and the uncaptured loop and their runs' ms, the
    device events and device-busy µs a step, the idle share, the chunk
    length and each chunk graph's capture seconds."""
    args = bench_inputs(device)
    loop._GRAPHS.clear()
    run(args, steps)                    # captures the chunks
    captures = loop._capture_seconds()
    runs = {"graphs": [], "uncaptured": []}
    enqueue = []
    for _ in range(ROUNDS):
        for k in runs:
            runs[k].append(_events_ms(
                lambda: run(args, steps, graphs=k == "graphs")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args, steps)
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    us = {k: min(v) / steps * 1e3 for k, v in runs.items()}
    events, busy = device_events(lambda: run(args, PROFILE_STEPS),
                                 PROFILE_STEPS)
    loop._GRAPHS.clear()
    return {"us": us, "runs_ms": runs, "events": events, "busy_us": busy,
            "enqueue_us": min(enqueue) / steps * 1e6,
            "idle": 1.0 - busy / us["graphs"] if busy > 0 else float("nan"),
            "chunk": loop._EAGER_GRAPH_STEPS, "captures": captures,
            "steps": steps}


def device_events(fn, steps: int):
    """(device events, device-busy µs) a step of ``fn``, a run of
    ``steps`` steps, from a ``torch.profiler`` window (after one
    unprofiled run; an empty window is profiled again, PROFILE_TRIES in
    all)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    events = busy = 0.0
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kept = [(e.count, device_total(e)) for e in prof.key_averages()
                if device_total(e) > 0]
        events = sum(c for c, _ in kept) / steps
        busy = sum(t for _, t in kept) / steps
        if busy > 0:
            break
    return events, busy


def fleet_rate(device, steps=FLEET_STEPS) -> dict:
    """The eager fleet, 4096 × K=128, T=30, as graphs: scenario-steps/s
    (min of ROUNDS after a run that captures), its runs' ms, finite
    records, and the device events a step of a profiled step."""
    args = fleet_inputs(device)
    loop._GRAPHS.clear()
    final, rec = run(args, steps)
    finite = bool(torch.isfinite(rec.q).all() and torch.isfinite(rec.u).all())
    runs = [_events_ms(lambda: run(args, steps)) for _ in range(ROUNDS)]
    events, _ = device_events(lambda: run(args, 1), 1)
    loop._GRAPHS.clear()
    return {"rate": args[4].q.shape[0] * steps / (min(runs) / 1e3),
            "runs_ms": runs, "finite": finite, "steps": steps,
            "events": events}


def chunk_sweep(device, chunks, steps=SWEEP_STEPS) -> list:
    """Rows of ``--chunks`` (module docstring), the uncaptured loop's row
    first."""
    args = bench_inputs(device)
    keep = loop._EAGER_GRAPH_STEPS
    rows = [{"S": None, "runs_ms": [],
             "sha256": _run_digest(*run(args, steps, graphs=False))}]
    rows += [{"S": S, "runs_ms": []} for S in chunks]
    try:
        for row in rows[1:]:
            loop._EAGER_GRAPH_STEPS = row["S"]
            loop._GRAPHS.clear()
            row["sha256"] = _run_digest(*run(args, steps))
            row["capture_s"] = loop._capture_seconds()
        for _ in range(ROUNDS):
            for row in rows:
                loop._EAGER_GRAPH_STEPS = row["S"] or keep
                row["runs_ms"].append(_events_ms(
                    lambda: run(args, steps, graphs=row["S"] is not None)))
        for row in rows:
            row["us_per_step"] = min(row["runs_ms"]) / steps * 1e3
            row["run_4000_s"] = (sum(row.get("capture_s", {}).values())
                                 + STEPS * row["us_per_step"] / 1e6)
    finally:
        loop._EAGER_GRAPH_STEPS = keep
        loop._GRAPHS.clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=SWEEP_STEPS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("eager_loop: no CUDA device; the graphs replay on the GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    where = card()
    if a.chunks:
        rows = chunk_sweep(device, a.chunks, a.steps)
        for row in rows:
            label = "uncaptured" if row["S"] is None else f"S={row['S']}"
            caps = ", ".join(f"{n} steps {t:.3f} s" for n, t in
                             sorted(row.get("capture_s", {}).items()))
            print(f"[{where}] eager loop {label}: {row['us_per_step']:.2f} "
                  f"us/step over {a.steps} steps (runs "
                  f"{[round(t, 1) for t in row['runs_ms']]} ms); captures "
                  f"{caps or 'none'}; projected {STEPS}-step run "
                  f"{row['run_4000_s']:.2f} s; sha256 {row['sha256']}")
        if len({row["sha256"] for row in rows}) != 1:
            print("eager_loop: the chunk lengths' bits differ",
                  file=sys.stderr)
            return 1
        return 0
    t0 = time.perf_counter()
    for label, diffs in check_bits(device):
        bad = {k: v for k, v in diffs.items() if v != 0.0}
        print(f"[{where}] {label}: "
              + (f"max |d| {bad}" if bad else "bitwise"))
    t = time_loop(device)
    print(f"[{where}] eager loop at benchmark_preset: graphs of "
          f"{t['chunk']} steps {t['us']['graphs']:.2f} us/step (enqueued in "
          f"{t['enqueue_us']:.2f}), uncaptured "
          f"{t['us']['uncaptured']:.2f} us/step; {t['events']:.1f} device "
          f"events a step, device busy {t['busy_us']:.2f} us/step, idle "
          f"share {t['idle']:.3f}; captures {t['captures']}")
    f = fleet_rate(device)
    print(f"[{where}] eager fleet {FLEET} x K=128 T=30: {f['rate']:,.0f} "
          f"scenario-steps/s over {f['steps']} steps (runs "
          f"{[round(v, 1) for v in f['runs_ms']]} ms), {f['events']:.1f} "
          f"device events a step, finite {f['finite']}; "
          f"{time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
