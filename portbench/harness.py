"""One run of one cell: find its parts by name, set up, measure, check.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — the configuration as it is run;
* ``traffic/<traffic>.json`` — the mix: the driver that generates it and
  its parameters;
* ``drivers/<driver>.py`` — one kind of traffic: ``prepare`` (inputs and
  warm-up, counted in set-up), ``window`` (the measured seconds; it calls
  ``closed()`` as it closes, which ends a trace) and
  ``cases`` (what the window produced and what it was given, for the
  check, with ``KIND`` naming how ``judge.py`` compares them);
* ``kinds/<kind>.py`` — a comparison of its own, for a ``KIND`` that is
  not one of ``judge.KINDS``: ``readings``, ``control`` and ``count``
  (``judge.kind``);
* ``limits/<workload>.json`` — the limit of each reading of the cell;
* ``endtoend/<metric>.py`` and ``metrics/<metric>.py`` — one metric each,
  ``read(run)`` returning its value, or None where it finds nothing.

So a later change adds a cell, a configuration or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mppi_robotarm_tpu")


class Cell(NamedTuple):
    """A workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    root: Path
    conf: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict


class Run(NamedTuple):
    """What the metric readers read: the cell, its window, the trace of
    the window (None untraced), set-up seconds and the device memory
    peak."""

    cell: Cell
    window: object
    trace: object
    setup_s: float
    peak_bytes: int


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` and its parts;
    KeyError for a name it lacks."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name, root, _json(root / conf["file"]),
                _json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
                w["chips"], mine(bench["end_to_end"]),
                mine(bench["per_layer"]),
                _json(root / "portbench" / "limits" / f"{name}.json"))


def load(root: Path, kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` under ``root`` (a name may
    hold dots)."""
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def steady():
    """The window's host conditions: the garbage collector's pauses kept
    out (what set-up left is frozen, collection off until the window
    closes), as a real-time caller keeps them out of its control loop."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    relatives' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=print) -> dict:
    """Set up, run the window (traced or not), read the memory peak, check
    what the window produced, read the metrics.  Returns the result's
    fields: correct, attempted, failed, metrics, memory_peak_bytes, the
    trace's busy_s, window_s and breakdown, and the checks as (name,
    value, limit)."""
    import torch

    from . import judge
    from . import trace as tracing

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver = load(cell.root, "drivers", cell.traffic["driver"])
    kind = judge.kind(driver.KIND, cell.root)
    t_prep = time.perf_counter()
    ctx = driver.prepare(cell, seed, device)
    log(f"set-up: {t_prep - t_start:.2f} s to the driver, "
        f"{time.perf_counter() - t_prep:.2f} s in its prepare")
    with steady():
        if trace:
            win, tr = tracing.traced(
                lambda closed: driver.window(ctx, seconds, closed))
        else:
            win, tr = driver.window(ctx, seconds), None
    setup_s = win.t0 - t_start        # up to the first timed step
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window: {win.t1 - win.t0:.3f} s, {win.calls} entry calls, "
        f"{win.attempted} solves attempted, {win.solves} live "
        f"({100.0 * win.solves / max(win.attempted, 1):.2f} %), "
        f"launches {win.counters}")
    if win.tracking_mm is not None:
        log(f"tracking: on-path mean {win.tracking_mm:.2f} mm over the first "
            f"1500 live steps of a chain or episode (bench.py's gate: 42 mm)")
    t_check = time.perf_counter()
    inp, prog, readings = driver.cases(ctx, win)
    readings.update(kind.readings(ctx.P, ctx.ref, inp, prog, judge.F64))
    log(f"check: {kind.count(inp)} answers compared")
    log(f"check: {time.perf_counter() - t_check:.2f} s")
    correct, rows, info = judge.verdict(readings, cell.limits)
    for name, value in info:
        log(f"check (not held to a limit) {name}: {value!r}")
    run = Run(cell, win, tr, setup_s, peak)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load(cell.root, "metrics" if trace else "endtoend",
                     m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.attempted - win.solves, "metrics": metrics,
           "memory_peak_bytes": peak, "checks": rows}
    if tr is not None:
        out.update(busy_s=tr.busy_s, window_s=tr.window_s,
                   breakdown=tr.breakdown())
    return out


def result_line(out: dict, kind: str, count: int) -> str:
    """The run's last line of standard output: the result's keys, the
    checks last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "busy_s" in out:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    plain = lambda v: v if math.isfinite(v) else str(v)
    line["checks"] = {n: {"value": plain(v), "limit": lim}
                      for n, v, lim in out["checks"]}
    return json.dumps(line)


def check_lines(out: dict) -> list:
    return [f"check {n}: {v!r} (limit {lim!r})" for n, v, lim in
            out["checks"]] + [f"correct: {out['correct']}"]


def card(device_index: int = 0) -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them (copy of
    ``mppi_robotarm_tpu_torch/tools/overhead.py::card`` at commit
    d2639e896f1da7d6fb6d2da3ddbb0eafdbf006c7); None where it cannot."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
