"""The port's own spans in a traced window, and the device's idle time laid
over them.

While the profiler runs, the port records spans at its host-side layer
boundaries (``mppi_robotarm_tpu_torch/utils/spans.py``) on the clock the
profiler stamps its events with.  This module takes the spans that
overlap the trace's span, clipped to it; sums them by name; and lays the
trace's idle gaps (``stats.gaps`` over its device operations) over them,
putting each stretch of a gap down to the innermost span that covers it,
or else to :data:`OUTSIDE`, the caller's own code.  Every stretch of idle
time goes to exactly one of them, so the parts add up to the trace's idle
time.  Nothing is read where the program records no spans (a program
older than them) or where its ring dropped spans that reached into the
window: :func:`of_run` returns None.

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>

runs a cell's set-up and one traced window, as the benchmark's ``--trace
1`` run does, and prints the window's idle time by span name and by the
root span of the call it fell in, with the cell's per-layer metrics.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import NamedTuple, Optional

from . import stats

OUTSIDE = "outside the port"
PROGRAM_SPANS = "mppi_robotarm_tpu_torch.utils.spans"


class Laid(NamedTuple):
    """A window's spans and its idle time laid over them, in nanoseconds:
    ``spans`` clipped to the window; ``held`` the time each name's spans
    held, summed; ``idle`` the idle time by the innermost span's name (or
    :data:`OUTSIDE`); ``idle_by_root`` by the name of the root span of the
    call it fell in (or :data:`OUTSIDE`); ``idle_ns`` all of it."""

    spans: list
    held: dict
    idle: dict
    idle_by_root: dict
    idle_ns: int


def recorded(span: tuple) -> Optional[list]:
    """The program's spans that overlap ``span`` (the trace's (start,
    end)), clipped to it; None where the program has no spans or its ring
    dropped some that reached into the window."""
    try:
        program = importlib.import_module(PROGRAM_SPANS)
    except ImportError:
        return None
    lo, hi = span
    got = program.between(lo, hi)
    if got.dropped:
        return None
    return [s._replace(start=max(s.start, lo), end=min(s.end, hi))
            for s in got.spans]


def innermost(spans: list) -> list:
    """The stretches of time the spans cover, as (start, end, the span
    innermost there), in order.  Spans of one thread nest: each lies
    inside its parent."""
    spans = [s for s in spans if s.end > s.start]
    edges = sorted([(s.start, 1, s.index) for s in spans]
                   + [(s.end, 0, s.index) for s in spans])
    by_index = {s.index: s for s in spans}
    out, stack, at = [], [], None
    for t, opens, i in edges:
        if stack and t > at:
            out.append((at, t, by_index[stack[-1]]))
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        at = t
    return out


def lay(trace, spans: list) -> Laid:
    """The trace's idle gaps laid over ``spans`` (clipped to its span)."""
    held, idle, by_root = {}, {}, {}
    for s in spans:
        held[s.name] = held.get(s.name, 0) + (s.end - s.start)
    roots = {s.index: s.name for s in spans if s.parent == -1}
    covered = innermost(spans)
    gaps = stats.gaps([(a, b) for _, a, b in trace.ops], *trace.span)
    total, k = 0, 0

    def add(d: dict, key: str, ns: int) -> None:
        d[key] = d.get(key, 0) + ns

    for a, b, _ in gaps:
        total += b - a
        while k < len(covered) and covered[k][1] <= a:
            k += 1
        t, j = a, k
        while t < b:
            if j < len(covered) and covered[j][0] < b:
                c0, c1, s = covered[j]
                if c0 > t:                     # uncovered up to c0
                    add(idle, OUTSIDE, c0 - t)
                    add(by_root, OUTSIDE, c0 - t)
                    t = c0
                end = min(c1, b)
                add(idle, s.name, end - t)
                add(by_root, roots.get(s.root, OUTSIDE), end - t)
                t = end
                if c1 <= b:
                    j += 1
            else:
                add(idle, OUTSIDE, b - t)
                add(by_root, OUTSIDE, b - t)
                t = b
    return Laid(spans, held, idle, by_root, total)


_last: list = [None, None]      # the trace last laid, and what it gave


def of_run(run) -> Optional[Laid]:
    """:func:`lay` of a traced run's window, laid once for all its
    readers; None where the trace holds no device operation or the
    program's spans cannot be read."""
    if run.trace is None or not run.trace.ops:
        return None
    if _last[0] is not run.trace:
        spans = recorded(run.trace.span)
        _last[:] = [run.trace,
                    None if spans is None else lay(run.trace, spans)]
    return _last[1]


def under(laid: Laid, root: str) -> list:
    """The spans of the calls whose root span is called ``root``."""
    roots = {s.index for s in laid.spans
             if s.parent == -1 and s.name == root}
    return [s for s in laid.spans if s.root in roots]


def table(laid: Laid, trace) -> dict:
    """The window's idle time by span name and by root, in seconds, with
    the trace's own idle time and the share the spans and OUTSIDE add up
    to."""
    sec = lambda d: {k: v * 1e-9 for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])}
    idle_s = trace.window_s - trace.busy_s
    return {"idle_by_span": sec(laid.idle),
            "idle_by_root": sec(laid.idle_by_root),
            "held_by_span": sec(laid.held), "idle_s": idle_s,
            "laid_over_idle": (laid.idle_ns * 1e-9 / idle_s if idle_s
                               else None),
            "window_s": trace.window_s, "busy_s": trace.busy_s,
            "spans": len(laid.spans)}


def main(argv=None) -> int:
    import torch

    from . import harness
    from . import trace as tracing

    ap = argparse.ArgumentParser(prog="portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    driver = harness.load(cell.root, "drivers", cell.traffic["driver"])
    device = torch.device("cuda", 0)
    ctx = driver.prepare(cell, args.seed, device)
    with harness.steady():
        win, tr = tracing.traced(
            lambda closed: driver.window(ctx, args.seconds, closed))
    run = harness.Run(cell, win, tr, 0.0, 0)
    laid = of_run(run)
    if laid is None:
        print("portbench.spans: no spans of the program in the window",
              file=sys.stderr)
        return 1
    out = {"workload": cell.name, "seed": args.seed, "calls": win.calls,
           "solves": win.solves, **table(laid, tr), "metrics": {
               m["name"]: harness.load(cell.root, "metrics",
                                       m["name"]).read(run)
               for m in cell.per_layer}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
