"""Traffic: one caller driving the controller a control step at a time, as
a robot's controller does: ``solve(backend="cuda", seed=, step=)``, the
per-call CUDA graph of the step head and K2, against a plant on the host.

A closed loop: each call hands in the robot's state, waits for the solve
and reads u0 back to the host, then the plant (the benchmark's own
float64 copy of the arm dynamics, ``reference/arm.py::step_host``) steps
the robot by the plant's dt.  A call's latency runs from the state handed
in to u0 on the host.  Episodes of ``episode_steps`` calls start from the
configuration's initial state and warm start with a seed of their own,
drawn from ``--seed`` and the episode's index, the call's index in its
episode being the solve's step.  The calls the check compares are one in
``keep_every``, at an offset drawn from the seed: their inputs and
results are kept by reference (the solve returns fresh tensors).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import inputs, judge, program
from portbench.chains import Window, sync
from portbench.reference import arm as arm_model

WARM_EPISODE = 1 << 30        # the warm-up calls' episode index
WARM_CALLS = 3                # uncaptured, captured, replayed
KIND = "calls"                # judge.call_readings compares them


class Realtime(NamedTuple):
    P: dict
    arm: object
    cfg: object
    sim: object
    ref: torch.Tensor
    device: torch.device
    seed: int
    episode_steps: int
    keep_every: int


def _call(rt: Realtime, x, state, seed: int, step: int):
    """One control step as the caller sees it: (the state handed in on the
    device, the solve's result, u0 on the host)."""
    xd = torch.tensor(x, dtype=torch.float32, device=rt.device)
    res = program.port.solve(rt.arm, rt.cfg, rt.ref, xd, state,
                             backend="cuda", seed=seed, step=step)
    return xd, res, res.u0.cpu().numpy()


def _x0(P: dict):
    return (*P["sim"]["q0"], *P["sim"]["dq0"])


def prepare(cell, seed: int, device: torch.device) -> Realtime:
    P, tr = cell.conf, cell.traffic
    arm, cfg, sim = program.configs(P)
    ref = torch.as_tensor(inputs.circle_path(P["path"]["waypoints"],
                                             P["sim"]["dt"]), device=device)
    rt = Realtime(P, arm, cfg, sim, ref, device, seed, tr["episode_steps"],
                  tr["keep_every"])
    state, x = program.port.init_state(cfg, device=device), _x0(P)
    s = int(inputs.seeds(seed, WARM_EPISODE, 1)[0])
    for k in range(WARM_CALLS):
        _, res, _ = _call(rt, x, state, s, k)
        state = res.state
    sync(device)
    return rt


def window(rt: Realtime, seconds: float, closed=lambda: None) -> Window:
    """Episodes back to back until ``seconds`` have passed, stopping after
    the call that crosses it; ``closed()`` runs the moment the window
    closes, before the live calls are counted and the first episode's
    tracking is read."""
    P = rt.P
    dt, dist = P["sim"]["dt"], tuple(P["sim"]["disturbance"])
    offset = int(inputs.rng(rt.seed, 2).integers(rt.keep_every))
    latencies, ends, finite, kept, first = [], [], [], [], []
    before = program.counters()
    sync(rt.device)
    t0 = time.perf_counter()
    i, ep, over = 0, 0, False
    while not over:
        s = int(inputs.seeds(rt.seed, ep, 1)[0])
        state, x = program.port.init_state(rt.cfg, device=rt.device), _x0(P)
        for k in range(rt.episode_steps):
            c0 = time.perf_counter()
            xd, res, u0 = _call(rt, x, state, s, k)
            c1 = time.perf_counter()
            latencies.append(c1 - c0)
            ends.append(res.path_end)
            finite.append(bool(np.isfinite(u0).all()))
            if i % rt.keep_every == offset:
                kept.append((xd, state, s, k, res))
            x = arm_model.step_host(P["arm"], x, u0, dt, dist)
            if ep == 0:
                first.append(x)
            state = res.state
            i += 1
            if c1 - t0 >= seconds:
                over = True
                break
        ep += 1
    t1 = time.perf_counter()
    closed()
    after = program.counters()
    live = int((~torch.stack(ends).cpu().numpy() & np.array(finite)).sum())
    q = torch.as_tensor(np.array(first)[:, :2])
    ee = torch.stack(arm_model.fk(q[:, 0], q[:, 1], P["arm"]["l1"],
                                  P["arm"]["l2"]), dim=1).numpy()
    return Window(t0, t1, i, live, i, latencies,
                  {k: after[k] - before[k] for k in after}, kept,
                  judge.onpath_mean_mm(ee, np.zeros(len(ee), bool),
                                       rt.ref[:, :2].cpu().numpy()))


def cases(rt: Realtime, win: Window):
    """What the check compares: (the kept calls' inputs, their results,
    no further readings)."""
    col = lambda v: torch.as_tensor(v, dtype=torch.int64,
                                    device=rt.device).reshape(1)
    inp, prog = [], []
    for xd, st, s, k, res in win.kept:
        inp.append({"q": xd[None, :2], "dq": xd[None, 2:],
                    "u_prev": st.u_prev[None], "wp": st.wp_idx.reshape(1),
                    "seed": col(s), "step": col(k)})
        prog.append({"u0": res.u0[None], "u_new": res.u_seq[None],
                     "u_next": res.state.u_prev[None],
                     "wp": res.state.wp_idx.reshape(1),
                     "path_end": res.path_end.reshape(1),
                     "costs": res.costs[None], "weights": res.weights[None]})
    cat = lambda ds: {k: torch.cat([d[k] for d in ds]) for k in ds[0]}
    return cat(inp), cat(prog), {}
