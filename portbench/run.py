"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (imports, CUDA, the kernels' build
and load, inputs, warm-up) runs first and is timed from the start of this
module; then the window measures for ``--seconds``; then what it produced
is checked against the plain reference.  With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a profiled window.  The last lines of standard error are
each number compared beside its limit, and the last line of standard
output is the result as one JSON object.  Exits non-zero, with no result,
without CUDA or with fewer cards than the cell asks for, when the program
cannot be imported, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"portbench: the cell needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    log(f"set-up: {time.perf_counter() - T_START:.2f} s to CUDA")
    out = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START, log)
    log(f"device: {kind}; nvidia-smi: {harness.card()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    found = harness.forbidden_modules()
    if found:
        log(f"portbench: loaded in this process: {', '.join(found)}")
        return 3
    for line in harness.check_lines(out):
        log(line)
    print(harness.result_line(out, kind, cell.chips), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
