"""The per-call entry points on the GPU: CUDA graphs against uncaptured
calls, their bits and their times.

On the card ``solve`` (both backends), ``solve_batched`` and
``viz_rollouts`` run as one CUDA graph a key (``mppi/solver.py::_call``):
a key's first call uncaptured, its second captured, every later one a
replay.  ``utils/cuda_graphs.py::uncaptured`` runs every call uncaptured,
the yardstick here.  Default mode, each comparison graphs against uncaptured,
in turns, min of ROUNDS, CUDA events:

* the compat drop-in (:func:`compat_bits`, :func:`compat_rate`) at
  ``examples/reference_drop_in.py``'s configuration (K=100, T=30,
  ``visualize_optimal_traj=True``, ``synth_circle_path(2000)``,
  ``np.random.seed(0)``, the plant stepped on the host as run.py does) on
  both backends: the largest |difference| of every returned array and the
  waypoint index over DROP_IN_CALLS calls (0 where bitwise); ms a call
  and calls/s; device events and device-busy µs a call from a profiled
  window of PROFILE_CALLS calls; the host's µs a call (the wall time a
  call less its device-busy time: what the card waits on the host); each
  graph's capture seconds;
* one ``solve(backend="eager")`` and one ``viz_rollouts`` at
  ``benchmark_preset`` (K=1024, T=50) and ``viz_rollouts`` at the drop-in's
  K=100, T=30 (:func:`chain_check`): a chain of CHAIN_CALLS calls, each
  fed the last one's state, every field of every result against the
  uncaptured chain's, and µs a call;
* ``solve_batched`` on the fleet, 4096 x K=128, T=30 (:func:`chain_check`),
  the same;
* what the capturing call left reserved on the card (the graph's pool and
  its input buffers) at ``benchmark_preset`` and on the fleet.

    python -m mppi_robotarm_tpu_torch.tools.call_graphs [--calls N]

Without an NVIDIA GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

import mppi_robotarm_tpu_torch as m
from mppi_robotarm_tpu_torch.compat import (Arm_Dynamic,
                                            MPPIControllerForPathTracking)
from mppi_robotarm_tpu_torch.mppi import solver
from mppi_robotarm_tpu_torch.tools.eager_loop import device_events
from mppi_robotarm_tpu_torch.tools.fused_timing import (ROUNDS, _events_ms,
                                                        fleet_inputs)
from mppi_robotarm_tpu_torch.tools.overhead import card
from mppi_robotarm_tpu_torch.utils import cuda_graphs

DROP_IN_CALLS = 500   # compat calls a timed run
SMOKE_CALLS = 200     # chip_smoke phase 28's compat calls
PROFILE_CALLS = 10    # compat calls of the profiled window
CHAIN_CALLS = 20      # calls of a solve or re-rollout chain
DT = 0.003            # run.py's plant step


def _mode(graphs: bool):
    return contextlib.nullcontext() if graphs else cuda_graphs.uncaptured()


def drop_in(backend: str, device):
    """``examples/reference_drop_in.py``'s controller on ``backend``, with
    the global NumPy stream seeded 0 as that script seeds it."""
    np.random.seed(0)
    return MPPIControllerForPathTracking(
        delta_t=DT * 2.0, ref_path=m.synth_circle_path(2000),
        horizon_step_T=30, number_of_samples_K=100, param_exploration=0.0,
        param_lambda=100.0, param_alpha=0.98,
        sigma=np.array([[20.0, 0.0], [0.0, 20.0]]),
        stage_cost_weight=np.array([0.5, 0.5, 5.0, 5.0]),
        terminal_cost_weight=np.array([5.0, 5.0, 50.0, 50.0]),
        visualize_optimal_traj=True, visualze_sampled_trajs=False,
        backend=backend, device=device)


def drive(ctrl, calls: int) -> list:
    """``calls`` steps of the reference's loop (run.py:48-71) on ``ctrl``:
    [(u0, u_seq, optimal_traj, sampled_traj_list, waypoint index)] a
    call; stops early at the path end."""
    q, dq = np.array([1.1522, -1.2661]), np.zeros(2)
    out = []
    for _ in range(calls):
        try:
            u0, u_seq, opt, sampled = ctrl.calc_control_input(
                np.concatenate([q, dq]))
        except IndexError:
            break
        out.append((u0, u_seq, opt, sampled, ctrl.prev_waypoints_idx))
        dq = dq + DT * Arm_Dynamic(q, dq, u0)
        q = q + DT * dq
    return out


def compat_run(backend: str, device, calls: int, graphs: bool) -> list:
    """:func:`drive` on a fresh drop-in controller, as graphs or not."""
    with _mode(graphs):
        return drive(drop_in(backend, device), calls)


def compat_bits(a: list, b: list) -> dict:
    """{field: largest |a - b|} over two :func:`drive` runs (0.0 where
    bitwise; ``calls`` the two runs' lengths when they differ)."""
    names = ("u0", "u_seq", "optimal_traj", "sampled_traj_list", "wp_idx")
    out = {k: 0.0 for k in names}
    if len(a) != len(b):
        out["calls"] = float(abs(len(a) - len(b)))
    for ra, rb in zip(a, b):
        for k, x, y in zip(names, ra, rb):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            if not np.array_equal(x, y, equal_nan=True):
                out[k] = max(out[k], float(np.nanmax(np.abs(x - y))))
    return out


def captures() -> dict:
    """{entry point: capture seconds} of the cached per-call graphs."""
    return {k[0]: g.captured.capture_s for k, g in solver._CALL_GRAPHS.items()
            if g.captured is not None}


def compat_events(backend: str, device, graphs: bool) -> tuple:
    """(device events, device-busy µs) a drop-in call, from a profiled
    window of PROFILE_CALLS calls past each key's first two."""
    with _mode(graphs):
        ctrl = drop_in(backend, device)
        drive(ctrl, 2)
        return device_events(lambda: drive(ctrl, PROFILE_CALLS),
                             PROFILE_CALLS)


def compat_rate(backend: str, device, calls: int = DROP_IN_CALLS,
                rounds: int = ROUNDS) -> dict:
    """The drop-in's rates on ``backend`` (module docstring).  A first run
    of ``calls`` calls as graphs captures them (and gives the bits);
    then graphs and uncaptured in turns, ``rounds`` each."""
    solver._CALL_GRAPHS.clear()
    t0 = time.perf_counter()
    first = compat_run(backend, device, calls, True)
    first_s = time.perf_counter() - t0
    caps = captures()
    runs = {"graphs": [], "uncaptured": []}
    bits = None
    for _ in range(rounds):
        for k in runs:
            res = []
            runs[k].append(_events_ms(lambda: res.append(compat_run(
                backend, device, calls, k == "graphs"))))
            if k == "uncaptured" and bits is None:
                bits = compat_bits(first, res[0])
    n = len(first)
    ms = {k: min(v) / n for k, v in runs.items()}
    prof = {k: compat_events(backend, device, k == "graphs") for k in runs}
    solver._CALL_GRAPHS.clear()
    return {"backend": backend, "calls": n, "ms": ms,
            "calls_per_s": {k: 1e3 / v for k, v in ms.items()},
            "runs_ms": runs, "first_run_s": first_s, "bits": bits,
            "events": {k: v[0] for k, v in prof.items()},
            "busy_us": {k: v[1] for k, v in prof.items()},
            "host_us": {k: ms[k] * 1e3 - prof[k][1] for k in runs},
            "captures": caps}


def _fields(v, prefix=""):
    """(name, tensor) of every tensor of a nested result."""
    if isinstance(v, torch.Tensor):
        return [(prefix, v)]
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return [f for k, x in zip(v._fields, v)
                for f in _fields(x, f"{prefix}.{k}" if prefix else k)]
    return []


def differences(a: list, b: list) -> dict:
    """{field: largest |a - b|} over two chains of results (0.0 where
    bitwise, NaN where they differ only in NaNs or in their dtypes)."""
    out: dict = {}
    for ra, rb in zip(a, b):
        for (k, x), (_, y) in zip(_fields(ra), _fields(rb)):
            d = 0.0
            if x.dtype != y.dtype or x.shape != y.shape:
                d = float("nan")
            elif not torch.equal(x, y):
                d = float((x.double() - y.double()).abs().max())
            out[k] = max(out.get(k, 0.0), d) if d == d else d
    return out


def solve_chain(arm, cfg, ref, x0, state, eps_list) -> list:
    """``len(eps_list)`` eager solves, each fed the last one's state."""
    out = []
    for eps in eps_list:
        res = solver.solve(arm, cfg, ref, x0, state, eps=eps)
        state = res.state
        out.append(res)
    return out


def viz_chain(arm, cfg, x0, results, u_prev0) -> list:
    """``viz_rollouts`` of each solve of a chain, on its pre-update
    sequence."""
    out, u_prev = [], u_prev0
    for res in results:
        out.append(solver.viz_rollouts(arm, cfg, x0, res.u_seq, u_prev,
                                       res.eps, res.costs))
        u_prev = res.state.u_prev
    return out


def batched_chain(arm, cfg, ref, x0, state, seeds, calls) -> list:
    """``calls`` seeded ``solve_batched`` calls, each fed the last one's
    state at the next step."""
    out = []
    for i in range(calls):
        res = solver.solve_batched(arm, cfg, ref, x0, state, seeds=seeds,
                                   step=torch.full_like(seeds, i))
        state = res.state
        out.append(res)
    return out


def _reserved_by(fn) -> int:
    """Bytes the card holds reserved after ``fn()`` beyond before, from an
    emptied cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_reserved() - r0


def chain_check(label: str, chain, calls: int = CHAIN_CALLS,
                rounds: int = ROUNDS) -> dict:
    """``chain(n)`` (a list of n results) as graphs against uncaptured:
    every field's largest |difference| over ``calls`` calls, µs a call
    (CUDA events, min of ``rounds`` in turns), the capture seconds, and
    what the capturing call left reserved.  The first call of the chain
    warms the key up, the second captures."""
    solver._CALL_GRAPHS.clear()
    chain(1)
    reserved = _reserved_by(lambda: chain(1))
    caps = captures()
    got = chain(calls)
    with cuda_graphs.uncaptured():
        want = chain(calls)
    runs = {"graphs": [], "uncaptured": []}
    for _ in range(rounds):
        for k in runs:
            with _mode(k == "graphs"):
                runs[k].append(_events_ms(lambda: chain(calls)))
    solver._CALL_GRAPHS.clear()
    return {"label": label, "diffs": differences(got, want),
            "us": {k: min(v) / calls * 1e3 for k, v in runs.items()},
            "runs_ms": runs, "captures": caps, "reserved": reserved,
            "calls": calls}


def bench_chains(device, calls: int = CHAIN_CALLS) -> list:
    """:func:`chain_check` of the eager solve and the re-rollouts at
    ``benchmark_preset`` in float32, the re-rollouts at the drop-in's
    configuration in float64 (the compat layer's dtype), and
    ``solve_batched`` on the fleet."""
    rows = []
    arm, cfg, _ = m.benchmark_preset()
    ctrl = drop_in("eager", device)
    for preset, arm, cfg, rows_n, dtype in (
            ("benchmark_preset", arm, cfg, 8000, torch.float32),
            ("the drop-in's configuration", ctrl._arm, ctrl._cfg, 2000,
             torch.float64)):
        ref = torch.as_tensor(m.synth_circle_path(rows_n), dtype=dtype,
                              device=device)
        state = solver.init_state(cfg, dtype=dtype, device=device)
        x0 = torch.tensor([1.1522, -1.2661, 0.0, 0.0], dtype=dtype,
                          device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        eps = [torch.randn((cfg.num_samples, cfg.horizon, 2), generator=gen,
                           dtype=dtype, device=device) * 20 ** 0.5
               for _ in range(calls)]
        solved = solve_chain(arm, cfg, ref, x0, state, eps)
        shape = f"K={cfg.num_samples}, T={cfg.horizon}, {dtype}"
        if preset == "benchmark_preset":
            rows.append(chain_check(
                f"solve(backend='eager') at {preset} ({shape})",
                lambda n: solve_chain(arm, cfg, ref, x0, state, eps[:n]),
                calls))
        rows.append(chain_check(
            f"viz_rollouts at {preset} ({shape})",
            lambda n: viz_chain(arm, cfg, x0, solved[:n], state.u_prev),
            calls))
    arm, cfg, sim, ref, states = fleet_inputs(device)
    x0 = torch.cat([states.q, states.dq], dim=-1)
    rows.append(chain_check(
        f"solve_batched on the fleet ({x0.shape[0]} x K={cfg.num_samples}, "
        f"T={cfg.horizon})",
        lambda n: batched_chain(arm, cfg, ref, x0, states.mppi,
                                states.seed, n), calls))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=DROP_IN_CALLS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("call_graphs: no CUDA device; the graphs replay on the GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    where = card()
    t0 = time.perf_counter()
    bad = False
    for backend in ("cuda", "eager"):
        r = compat_rate(backend, device, a.calls)
        diff = {k: v for k, v in r["bits"].items() if v != 0.0}
        bad |= bool(diff)
        print(f"[{where}] compat drop-in, backend {backend}, {r['calls']} "
              f"calls: graphs {r['ms']['graphs']:.3f} ms a call "
              f"({r['calls_per_s']['graphs']:.1f} calls/s), uncaptured "
              f"{r['ms']['uncaptured']:.3f} ms "
              f"({r['calls_per_s']['uncaptured']:.1f} calls/s); device "
              f"events a call {r['events']['graphs']:.1f} against "
              f"{r['events']['uncaptured']:.1f}, device busy "
              f"{r['busy_us']['graphs']:.1f} against "
              f"{r['busy_us']['uncaptured']:.1f} us, host "
              f"{r['host_us']['graphs']:.1f} against "
              f"{r['host_us']['uncaptured']:.1f} us a call; captures "
              f"{ {k: round(v, 4) for k, v in r['captures'].items()} } s; "
              f"runs {r['runs_ms']} ms; "
              + (f"max |d| {diff}" if diff else "bitwise"))
    for row in bench_chains(device):
        diff = {k: v for k, v in row["diffs"].items() if v != 0.0}
        bad |= bool(diff)
        print(f"[{where}] {row['label']}, {row['calls']} calls: graphs "
              f"{row['us']['graphs']:.1f} us a call, uncaptured "
              f"{row['us']['uncaptured']:.1f}; captures "
              f"{ {k: round(v, 4) for k, v in row['captures'].items()} } s; "
              f"the capturing call left {row['reserved'] / 2**20:.2f} MiB "
              f"reserved; runs {row['runs_ms']} ms; "
              + (f"max |d| {diff}" if diff else "bitwise"))
    print(f"[{where}] call_graphs: {time.perf_counter() - t0:.1f} s in all")
    if bad:
        print("call_graphs: graphs and uncaptured calls differ",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
