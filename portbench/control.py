"""The readings a cell's limits are set from: the program's on many seeds,
and the control's, the plain reference put in the program's place and
computed in the precision below the configuration's ``dtype``: bfloat16
below float32 (every cell's so far), float32 below float64.

    python3 -m portbench.control --workload <name> --seconds <s> \\
        --seeds <n> ... [--controls <k>]

runs the cell's set-up once, then for each seed the cell's own window at
the cell's load, the program's readings against the float64 reference,
and for the first ``--controls`` seeds the control's readings from the
same inputs.  Prints one JSON line a seed; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, judge

BELOW = {"float64": torch.float32, "float32": torch.bfloat16}


def below(conf: dict) -> torch.dtype:
    """The control's precision: the one below the configuration's."""
    return BELOW[conf.get("dtype", "float32")]


def seed_readings(cell, driver, seed: int, seconds: float, device,
                  control: bool) -> dict:
    """One seed's window and readings: the program's, and with ``control``
    the reference's in its place, in the precision :func:`below` the
    configuration's."""
    kind = judge.kind(driver.KIND, cell.root)
    ctx = driver.prepare(cell, seed, device)
    with harness.steady():
        win = driver.window(ctx, seconds)
    inp, prog, extra = driver.cases(ctx, win)
    read = lambda p: {**extra, **kind.readings(ctx.P, ctx.ref, inp, p,
                                               judge.F64)}
    out = {"seed": seed, "answers": kind.count(inp), "program": read(prog)}
    if control:
        out["control"] = read(kind.control(ctx.P, ctx.ref, inp,
                                           below(cell.conf)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    driver = harness.load(cell.root, "drivers", cell.traffic["driver"])
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = seed_readings(cell, driver, seed, args.seconds, device,
                            i < args.controls)
        out["s"] = round(time.perf_counter() - t0, 2)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
