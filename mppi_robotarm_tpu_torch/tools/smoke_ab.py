"""Run ``chip_smoke.py`` of several trees one after another, each output
line stamped with the seconds since its run began.

It is for an A/B of two trees on one card, as parent, change, change,
parent, where a whole-script time alone cannot say which phase moved:

    python -m mppi_robotarm_tpu_torch.tools.smoke_ab --out .ab_pre/logs \\
        --mark probes: --mark "soak, fused vs graph loop" \\
        parent=.ab_pre/parent change=. change=. parent=.ab_pre/parent

Each ``TAG=DIR`` runs ``python3 -u chip_smoke.py`` in DIR after removing
``DIR/build``, so that every run builds its kernels as a fresh checkout
does.  The n-th run writes its stamped standard output to
``OUT/n_TAG.log`` and its errors to ``OUT/n_TAG.err``.  A line a run is
printed: the tag, the exit code, the wall seconds and, for each
``--mark``, the stamp of the last output line that holds that text (None
where none does).  It exits non-zero when a run did.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from typing import List, Optional, Tuple


def stamped_run(cmd: List[str], cwd: str, log: str, err: str) -> Tuple[int,
                                                                       float]:
    """Run ``cmd`` in ``cwd``; each line of its standard output goes to
    ``log`` as ``"{seconds:9.2f}\\t{line}"``, its errors to ``err``.
    Returns (exit code, wall seconds)."""
    t0 = time.perf_counter()
    with open(log, "w") as out, open(err, "w") as errf:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                                stderr=errf, text=True)
        for line in proc.stdout:
            out.write(f"{time.perf_counter() - t0:9.2f}\t{line}")
            out.flush()
        rc = proc.wait()
    return rc, time.perf_counter() - t0


def mark_stamps(log: str, marks: List[str]) -> List[Optional[float]]:
    """The stamp of the last line of ``log`` holding each mark, or None."""
    found: List[Optional[float]] = [None] * len(marks)
    with open(log) as f:
        for line in f:
            stamp, _, text = line.partition("\t")
            for i, mark in enumerate(marks):
                if mark in text:
                    found[i] = float(stamp)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", metavar="TAG=DIR")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mark", action="append", default=[])
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    worst = 0
    for n, run in enumerate(a.runs, 1):
        tag, sep, tree = run.partition("=")
        if not sep:
            ap.error(f"{run!r} is not TAG=DIR")
        shutil.rmtree(os.path.join(tree, "build"), ignore_errors=True)
        log = os.path.join(a.out, f"{n}_{tag}.log")
        rc, wall = stamped_run([sys.executable, "-u", "chip_smoke.py"], tree,
                               log, os.path.join(a.out, f"{n}_{tag}.err"))
        marks = ", ".join(f"{m!r} {s}" for m, s in
                          zip(a.mark, mark_stamps(log, a.mark)))
        print(f"{n} {tag}: exit {rc} in {wall:.1f} s"
              + (f"; marks: {marks}" if marks else ""), flush=True)
        worst = worst or rc
    return 1 if worst else 0


if __name__ == "__main__":
    sys.exit(main())
