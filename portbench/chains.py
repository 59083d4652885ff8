"""Back-to-back closed-loop chains of one of the port's whole-run entries,
and the check of what they produced: the traffic of the drivers
``fused_chain``, ``step_loop`` and ``fleet_chain``, which differ only in
the entry they call and the state they start from.

The window runs chains until ``seconds`` have passed, each from its own
start with noise seeds drawn from ``--seed`` and the chain's index, and
synchronises after each, as a caller that reads its results does.  The
rate is every live solve of every chain over the whole window, the last
chain included.

What the window produced is checked once it has closed.  A chain's
controls are internal to the program between steps, so the check takes
them from the program itself: it runs the same entry again from the
chain's start for t steps (the port's loops are deterministic, and a run
chained from a returned state continues the first bit for bit), holds
the rerun's row t - 1 to the timed run's bit for bit, runs one step more,
holds that row to the timed run's row t the same way, and hands the
program's state at t and the timed row t, with the controls carried to
step t + 1, to the reference.  Chain 0 is checked at step 0, from the
start the benchmark made itself.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from . import inputs, judge, program

KIND = "rows"                  # judge.row_readings compares them

# the record fields a row check reads, by the reference's names
_RECORD = {"q": "q", "dq": "dq", "u": "u", "wp": "wp_idx", "done": "done",
           "cost_min": "cost_min", "cost_mean": "cost_mean", "ess": "ess",
           "entropy": "weight_entropy"}


class Window(NamedTuple):
    """What a window did: host-clock start and end (both after a
    synchronise), the solves attempted and those live, the entry's calls,
    each call's latency (calls only), the port's launch counts over the
    window, and what the check needs."""

    t0: float
    t1: float
    attempted: int
    solves: int
    calls: int
    latencies: list
    counters: dict
    kept: dict
    tracking_mm: Optional[float] = None


class ChainProgram(NamedTuple):
    """One whole-run entry of the port: ``start(c)`` the state chain c
    starts from, ``run(state, n)`` → (final state, record), ``batched``
    whether states and records carry a scenario axis."""

    P: dict
    device: torch.device
    ref: torch.Tensor
    steps: int
    check_chains: int
    check_from: int
    seed: int
    start: Callable
    run: Callable
    batched: bool


WARM_CHAIN = 1 << 30          # the warm-up chain's index


def prepare(cell, seed: int, device, make: Callable,
            batched: bool) -> ChainProgram:
    """A cell's ChainProgram: its configuration and path, and the entry
    ``make(arm, cfg, sim, ref)`` gives as (start, run).  Set-up runs one
    whole chain from a start no chain of the window uses."""
    P, tr = cell.conf, cell.traffic
    arm, cfg, sim = program.configs(P)
    ref = torch.as_tensor(inputs.circle_path(P["path"]["waypoints"],
                                             P["sim"]["dt"]), device=device)
    start, run = make(arm, cfg, sim, ref)
    cp = ChainProgram(P, device, ref, tr["chain_steps"], tr["check_chains"],
                      tr["check_from"], seed, start, run, batched)
    run(start(WARM_CHAIN), cp.steps)
    sync(device)
    return cp


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _row(rec, t: int, batched: bool) -> dict:
    """Row t of a record, each field with a leading scenario axis."""
    out = {}
    for k, f in _RECORD.items():
        v = getattr(rec, f)[t]
        out[k] = (v if batched else v[None]).clone()
    return out


def _state(st, batched: bool) -> dict:
    """A SimState as the reference's dict, with a leading scenario axis."""
    lead = (lambda v: v) if batched else (lambda v: v[None])
    seed = torch.as_tensor(st.seed, dtype=torch.int64, device=st.q.device)
    return {"q": lead(st.q), "dq": lead(st.dq),
            "u_prev": lead(st.mppi.u_prev), "wp": lead(st.mppi.wp_idx),
            "done": lead(st.done), "seed": seed.reshape(-1),
            "step": lead(st.step).reshape(-1)}


def picks(cp: ChainProgram) -> dict:
    """The chains the check compares and the step of each, drawn from the
    seed before the window: chain 0 at step 0, and ``check_chains`` - 1
    of chains 1 .. ``check_from`` - 1, each at a step of its own."""
    g = inputs.rng(cp.seed, 2)
    n = min(cp.check_chains - 1, cp.check_from - 1)
    chains = sorted(int(c) for c in g.choice(
        range(1, cp.check_from), size=n, replace=False)) if n > 0 else []
    return {0: 0, **{c: int(g.integers(1, max(cp.steps, 2)))
                     for c in chains}}


def window(cp: ChainProgram, seconds: float, closed=lambda: None,
           max_chains: int = 1 << 16) -> Window:
    """Chains back to back for ``seconds``; keeps each chain's live-solve
    count on the device and, of the chains :func:`picks` drew, the record
    rows the check reads.  ``closed()`` runs the moment the window closes.
    Then the live solves are summed and a single scenario's last chain
    gives the tracking: bench.py's on-path mean."""
    at = picks(cp)
    lives, kept, attempted = [], {}, 0
    before = program.counters()
    sync(cp.device)
    t0 = time.perf_counter()
    c = 0
    while c < max_chains:
        final, rec = cp.run(cp.start(c), cp.steps)
        live = ~rec.done & torch.isfinite(rec.q).all(-1) \
            & torch.isfinite(rec.u).all(-1)
        lives.append(live.sum())
        attempted += live.numel()
        if c in at:
            t = at[c]
            kept[c] = (t, {i: _row(rec, i, cp.batched) for i in (t - 1, t)
                           if i >= 0})
        last = None if cp.batched else rec
        del final, rec, live
        sync(cp.device)
        c += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    closed()
    after = program.counters()
    solves = int(torch.stack(lives).sum())
    mm = None if last is None else judge.onpath_mean_mm(
        last.ee.cpu().numpy(), last.done.cpu().numpy(),
        cp.ref[:, :2].cpu().numpy())
    return Window(t0, t1, attempted, solves, c, [],
                  {k: after[k] - before[k] for k in after}, kept, mm)


def _same(a: dict, b: dict) -> int:
    """Scenarios of two rows that differ in any bit of any field."""
    diff = None
    for k in _RECORD:
        d = (a[k] != b[k]).reshape(a[k].shape[0], -1).any(dim=1)
        diff = d if diff is None else diff | d
    return int(diff.sum())


def cases(cp: ChainProgram, win: Window):
    """What the check compares, for the chains :func:`picks` drew that the
    window ran, each at its step: (the program's states at those steps,
    what it produced there, {"rerun_miss": rows of the reruns that differ
    from the timed run's})."""
    states, progs, miss = [], [], 0
    for c in sorted(win.kept):
        t, rows = win.kept[c]
        st = cp.start(c)
        if t:
            st, rec = cp.run(st, t)
            miss += _same(_row(rec, t - 1, cp.batched), rows[t - 1])
            del rec
        nxt, rec = cp.run(st, 1)
        miss += _same(_row(rec, 0, cp.batched), rows[t])
        states.append(_state(st, cp.batched))
        progs.append({**rows[t], "u_next": _state(nxt, cp.batched)["u_prev"]})
        del nxt, rec
    cat = lambda ds: {k: torch.cat([d[k] for d in ds]) for k in ds[0]}
    return cat(states), cat(progs), {"rerun_miss": float(miss)}
