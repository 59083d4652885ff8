"""Time the pieces of the solve kernel's combine on the GPU, in SM cycles.

The combine runs in one block per scenario after its tiles are done
(``csrc/solve_kernel.cu::combine_solve``), so a profiler sees only the
kernel's whole time.  This script copies the package into
``build/combine_clocks/`` (gitignored), adds ``clock64`` stamps to that
copy's ``combine_solve`` (:func:`instrument`): at its entry, after the
arrival, after the staging of the partials and the min, after the folds,
and at its end, each after a barrier.  The combining block writes the four
differences, in cycles, over its first four outputs.  It then runs
``solve_batched`` in that copy (a subprocess with ``PYTHONPATH`` on it) at
``fused_timing.solve_shapes()``, 20 calls after 5 warm-ups, and prints per
shape the median over the calls of the slowest scenario's cycles by piece
(arrival, staging + min, folds, finish: the normalising, the median and the
stores), and their sum in µs at the card's highest SM clock.  A scenario of
one tile has no arrival, staging or folds across tiles: its whole combine
counts as finish.

Run on a machine with an NVIDIA GPU and the CUDA toolkit (without a card it
exits non-zero):

    python -m mppi_robotarm_tpu_torch.tools.combine_clocks
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
COPY = PACKAGE.parent / "build" / "combine_clocks"
CALLS, WARMUP = 20, 5
PIECES = ("arrival", "stage+min", "folds", "finish")

# (anchor, text inserted after it) in combine_solve; each anchor occurs once
_STAMPS = [
    ("  const int T2 = 2 * T, b = blockIdx.y, lt = threadIdx.x, "
     "lane = lt & 31;\n",
     "  const long long ck0 = clock64();\n"),
    ("    finish_solve(T, fw, normalize, fuse_update, s_fin, m1, ub, ob, "
     "m_out,\n                 eta_out, b);\n",
     "    __syncthreads();\n"
     "    if (lt == 0) {\n"
     "      ob[0] = ob[1] = ob[2] = 0.0f;\n"
     "      ob[3] = (float)(clock64() - ck0);\n"
     "    }\n"),
    ("    if (!s_last) return;\n  }\n",
     "  const long long ck1 = clock64();\n"),
    ("  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mg = fminf(mg, "
     "s_red[w]);\n",
     "  __syncthreads();\n  const long long ck2 = clock64();\n"),
    ("    fold_tiles(s_reg, n, c0 == 0, mg, lam, T, s_fin);\n  }\n",
     "  __syncthreads();\n  const long long ck3 = clock64();\n"),
    ("  finish_solve(T, fw, normalize, fuse_update, s_fin, mg, ub, ob, m_out,"
     "\n               eta_out, b);\n",
     "  __syncthreads();\n"
     "  if (lt == 0) {\n"
     "    ob[0] = (float)(ck1 - ck0);\n"
     "    ob[1] = (float)(ck2 - ck1);\n"
     "    ob[2] = (float)(ck3 - ck2);\n"
     "    ob[3] = (float)(clock64() - ck3);\n"
     "  }\n"),
]


def instrument(src: str) -> str:
    """``solve_kernel.cu``'s text with the stamps of :data:`_STAMPS`;
    raises if an anchor is missing or not unique."""
    for anchor, stamp in _STAMPS:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once: {anchor.strip()!r}")
        src = src.replace(anchor, anchor + stamp)
    return src


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0])


def measure():
    """[(shape, B, median cycles by piece)] in this process, which must
    import the instrumented copy."""
    import numpy as np
    import torch

    from mppi_robotarm_tpu_torch.ops import cuda_solve
    from mppi_robotarm_tpu_torch.tools import fused_timing

    device = torch.device("cuda", 0)
    rows = []
    for shape, B, K, T in fused_timing.solve_shapes():
        arm, cfg, x0, u, win, kw = fused_timing.solve_inputs(device, B, K, T)
        runs = []
        for i in range(WARMUP + CALLS):
            out = cuda_solve.solve_batched(arm, cfg, x0, u, win, **kw)[0]
            if i >= WARMUP:
                runs.append(out.reshape(B, -1)[:, :4].cpu().numpy())
        cycles = np.median(np.stack(runs).max(axis=1), axis=0)
        rows.append((shape, B, [float(c) for c in cycles]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="store_true",
                    help="measure in this process (the instrumented copy)")
    a = ap.parse_args(argv)
    if a.run:
        mhz = max_sm_clock_mhz()
        for shape, B, cycles in measure():
            print(f"combine {shape} B={B}: cycles "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(PIECES, cycles))
                  + f"; {sum(cycles) / mhz:.2f} us at {mhz:.0f} MHz")
        return 0
    if shutil.which("nvidia-smi") is None:
        print("combine_clocks: no NVIDIA GPU; it times the GPU",
              file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(PACKAGE, COPY / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    kernel = COPY / PACKAGE.name / "csrc" / "solve_kernel.cu"
    kernel.write_text(instrument(kernel.read_text()))
    env = dict(os.environ, PYTHONPATH=str(COPY))
    return subprocess.run([sys.executable, "-m",
                           "mppi_robotarm_tpu_torch.tools.combine_clocks",
                           "--run"], env=env, cwd=COPY).returncode


if __name__ == "__main__":
    sys.exit(main())
