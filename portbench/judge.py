"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/``) run in float64 from the
same inputs.

Each number is a widest gap over the sampled answers, and each has a
limit of its own in ``limits/<workload>.json``:

* ``wp_gap`` — how far the program's new waypoint index lies from the
  best row of its window, in the controller's metric (dx² + dy²)·
  dist_scale of the observed end effector (∞ for an index outside the
  window, or an index moved on a frozen step); the reference goes on
  from the program's index;
* ``u_gap`` — the largest |Δ| of the controls: the applied u0, and the
  whole sequence the step carries on (and, for a solve, its u_new);
* ``x_gap`` — the largest |Δ| of the plant's next q and dq (rows);
* ``stat_gap`` — the largest relative gap of the row's cost min, cost
  mean, ESS and weight entropy, each against max(|reference|, 1);
* ``cost_gap`` — the largest relative gap of a solve's per-sample costs,
  against max(|S_k|, the median |S|); ``weight_gap`` — the largest |Δ|
  of its weights (calls);
* ``flag_miss`` — rows or calls whose path-end flag differs;
* ``rerun_miss`` (set by the drivers) — rows of the program's own rerun
  that differ in any bit from the timed run's.

Each gap is read over every answer compared, as its widest (``u_gap``)
and its 99th percentile (``u_gap_p99``); a cell's limits file names the
readings held to a limit, and the others are printed beside them.  A NaN
reading, or a gap over no answer at all, counts as over its limit.

How a cell's answers are compared is its driver's ``KIND``, found by
:func:`kind`: "rows" and "calls" are the two above; any other name is a
file ``kinds/<name>.py`` beside the drivers, which brings its own
``readings``, ``control`` and ``count`` (and may use :func:`summary`).
Where the cases carry the noise each answer was drawn with (``eps``, (B,
K, T, 2)), the reference takes it in place of its own Philox stream.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from .reference import mppi

F64 = torch.float64
BLOCK = 1 << 24         # sample-steps the reference holds at once


def _blocks(P: dict, B: int):
    mp = P["mppi"]
    n = max(1, BLOCK // (mp["num_samples"] * mp["horizon"]))
    return [slice(i, min(B, i + n)) for i in range(0, B, n)]


def _cut(d: dict, s: slice) -> dict:
    return {k: v[s] for k, v in d.items()}


def _max(x: torch.Tensor) -> float:
    """The widest gap (NaN over nothing or with a NaN)."""
    x = x.double()
    if not x.numel() or torch.isnan(x).any():
        return float("nan")
    return float(x.max())


def _judged_index(P: dict, ref_path, st: dict, wp_prog, frozen):
    """(gap, index): the gap of the program's new index in the reference's
    window metric (∞ outside the window, or moved on a frozen step), and
    the index the reference goes on from: the program's where it lies in
    the window, so a near tie the program broke the other way, which the
    gap judges, does not part the two solves."""
    ref_path = ref_path.to(F64)
    wn, dist = mppi.advance(ref_path, st["wp"], st["q"][:, 0].to(F64),
                            st["q"][:, 1].to(F64), P["mppi"])
    off = wp_prog - st["wp"]
    ok = (off >= 0) & (off < dist.shape[1])
    d = torch.take_along_dim(dist, off.clamp(0, dist.shape[1] - 1)[:, None],
                             dim=1)[:, 0]
    gap = torch.where(ok, d - dist.min(dim=1).values, torch.inf)
    gap = torch.where(frozen, torch.where(off == 0, 0.0, torch.inf), gap)
    return gap, torch.where(ok, wp_prog, wn)


def _rel(p, r) -> torch.Tensor:
    r = r.double()
    return (p.double() - r).abs() / torch.clamp(r.abs(), min=1.0)


def row_readings(P: dict, ref_path: torch.Tensor, state: dict, prog: dict,
                 dtype=F64) -> dict:
    """Readings of B closed-loop steps: ``state`` the program's state
    before each (q, dq, u_prev, wp, done, and seed and step or the
    injected ``eps``), ``prog`` what it produced (the row's q, dq, u, wp,
    done, cost_min, cost_mean, ess, entropy, and ``u_next``, the controls
    its next step starts from)."""
    out = {"wp_gap": [], "u_gap": [], "x_gap": [], "stat_gap": [],
           "flag_miss": []}
    for s in _blocks(P, state["q"].shape[0]):
        st, pg = _cut(state, s), _cut(prog, s)
        gap, wp_new = _judged_index(P, ref_path, st, pg["wp"], st["done"])
        r = mppi.loop_step(P, ref_path, st, dtype, wp_new)
        out["wp_gap"].append(gap)
        out["u_gap"].append(torch.maximum(
            (pg["u"].double() - r["u"]).abs().amax(dim=1),
            (pg["u_next"].double() - r["u_next"]).abs().amax(dim=(1, 2))))
        out["x_gap"].append(torch.maximum(
            (pg["q"].double() - r["q"]).abs().amax(dim=1),
            (pg["dq"].double() - r["dq"]).abs().amax(dim=1)))
        out["stat_gap"].append(torch.stack(
            [_rel(pg[k], r[k]) for k in
             ("cost_min", "cost_mean", "ess", "entropy")]).amax(dim=0))
        out["flag_miss"].append((pg["done"] != r["done"]).double())
    return summary(out)


def call_readings(P: dict, ref_path: torch.Tensor, inp: dict, prog: dict,
                  dtype=F64) -> dict:
    """Readings of B solves: ``inp`` what each was handed (q, dq, u_prev,
    wp, and seed and step or the injected ``eps``), ``prog`` what it
    returned (u0, u_new, u_next, wp, path_end, costs, weights)."""
    out = {"wp_gap": [], "u_gap": [], "cost_gap": [], "weight_gap": [],
           "flag_miss": []}
    for s in _blocks(P, inp["q"].shape[0]):
        st, pg = _cut(inp, s), _cut(prog, s)
        no = torch.zeros_like(st["wp"], dtype=torch.bool)
        gap, wp_new = _judged_index(P, ref_path, st, pg["wp"], no)
        r = mppi.solve(P, ref_path, st["q"], st["dq"], st["u_prev"],
                       st["wp"], st.get("seed"), st.get("step"), dtype,
                       wp_new, st.get("eps"))
        out["wp_gap"].append(gap)
        du = lambda k: (pg[k].double() - r[k]).abs().flatten(1).amax(dim=1)
        out["u_gap"].append(torch.stack(
            [du("u0"), du("u_new"), du("u_next")]).amax(dim=0))
        scale = torch.clamp(r["costs"].abs(),
                            min=r["costs"].abs().median(dim=1,
                                                        keepdim=True).values)
        out["cost_gap"].append(((pg["costs"].double() - r["costs"]).abs()
                                / scale).amax(dim=1))
        out["weight_gap"].append(
            (pg["weights"].double() - r["weights"]).abs().amax(dim=1))
        out["flag_miss"].append((pg["path_end"] != r["path_end"]).double())
    return summary(out)


def _quantile(x: torch.Tensor, q: float) -> float:
    """Nearest-rank ``q``-quantile (NaN over nothing or with a NaN)."""
    x = x.double()
    if not x.numel() or torch.isnan(x).any():
        return float("nan")
    k = max(1, math.ceil(q * x.numel()))
    return float(torch.kthvalue(x.cpu(), k).values)


def summary(out: dict) -> dict:
    """Each gap over every answer: its widest (``<name>``) and its 99th
    percentile (``<name>_p99``); the count of flag misses."""
    res = {}
    for k, v in out.items():
        v = torch.cat(v)
        if k == "flag_miss":
            res[k] = float(v.sum())
        else:
            res[k], res[k + "_p99"] = _max(v), _quantile(v, 0.99)
    return res


def count(inp: dict) -> int:
    """Answers compared: scenario-steps or calls."""
    return int(inp["q"].shape[0])


def _control(step: Callable) -> Callable:
    """The control of a kind whose reference is ``step(P, ref_path, st,
    dtype)`` on a block of its inputs: the reference in ``dtype`` put in
    the program's place, what it produces from the same inputs in the
    program's output types."""
    def control(P: dict, ref_path, inp: dict, dtype) -> dict:
        out = {}
        for s in _blocks(P, count(inp)):
            for k, v in step(P, ref_path, _cut(inp, s), dtype).items():
                out.setdefault(k, []).append(
                    v.to(torch.float32) if v.is_floating_point() else v)
        return {k: torch.cat(v) for k, v in out.items()}
    return control


def _solve_of(P: dict, ref_path, st: dict, dtype) -> dict:
    return mppi.solve(P, ref_path, st["q"], st["dq"], st["u_prev"], st["wp"],
                      st.get("seed"), st.get("step"), dtype,
                      eps=st.get("eps"))


class Kind(NamedTuple):
    """How a cell's answers are compared: ``readings(P, ref_path, inp,
    prog, dtype)`` the gaps of what the program produced, ``control(P,
    ref_path, inp, dtype)`` the reference in ``dtype`` in the program's
    place, ``count(inp)`` the answers compared."""

    readings: Callable
    control: Callable
    count: Callable


KINDS = {"rows": Kind(row_readings, _control(mppi.loop_step), count),
         "calls": Kind(call_readings, _control(_solve_of), count)}


def kind(name: str, root: Path) -> Kind:
    """The kind ``name``: one of :data:`KINDS`, or else the file
    ``portbench/kinds/<name>.py`` under ``root`` (FileNotFoundError where
    there is none)."""
    if name in KINDS:
        return KINDS[name]
    from .harness import load

    mod = load(root, "kinds", name)
    return Kind(mod.readings, mod.control, mod.count)


def verdict(readings: dict, limits: dict):
    """(correct, [(name, value, limit)] of the readings the limits name,
    [(name, value)] of the others): every limited reading at or under its
    limit, NaN failing; a limit naming no reading is an error."""
    held = [(k, readings[k], limits[k]) for k in sorted(limits)]
    ok = all(not math.isnan(v) and v <= lim for _, v, lim in held)
    return ok, held, [(k, v) for k, v in sorted(readings.items())
                      if k not in limits]


def onpath_mean_mm(ee, done, path_xy, first: int = 1500) -> float:
    """Mean distance in mm of the end effector to the nearest path point
    over the first ``first`` live steps (NaN when none is live).  Frozen
    copy of ``mppi_robotarm_tpu_torch/utils/metrics.py::onpath_mean_mm``
    at commit d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7."""
    ee = np.asarray(ee)[~np.asarray(done, dtype=bool)][:first]
    path_xy = np.asarray(path_xy)
    if not len(ee):
        return float("nan")
    d = [np.linalg.norm(ee[i:i + 256, None, :] - path_xy[None], axis=-1)
         .min(axis=1) for i in range(0, len(ee), 256)]
    return float(np.concatenate(d).mean() * 1e3)
