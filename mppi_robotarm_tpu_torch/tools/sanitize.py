"""Run the port's closed-loop and solve kernels under NVIDIA's
``compute-sanitizer`` at short shapes, one process per (tool, case).

The counterpart of ``mppi_robotarm_tpu/utils/debug.py::kernel_race_check``
(which runs a Pallas kernel in the Mosaic interpreter's race detector): here
``racecheck`` looks for shared-memory hazards, ``synccheck`` for barriers
used where not every thread arrives, and ``memcheck`` for out-of-bounds
and misaligned accesses.  The cases:

- ``k1-c{2,4,8}-{eps,prng}``: ``sim_kernel`` at ``benchmark_preset``
  (K=1024, H=50) on a cluster of C blocks, 8 steps;
- ``k3-{128,90}-{eps,prng}``: ``fleet_kernel`` at K=128 (four warps a
  scenario) and K=90 (two warps of two samples a lane), T=30, 16 scenarios
  in groups of 8, half of them frozen, 8 steps;
- ``k2-{1024,65536}``: ``solve_batched`` of one scenario at H=50, PRNG
  mode with the fused update (four lanes a sample at K=1024, one at
  K=65536 on an H100), and ``k2-1024-b64``: 64 scenarios, one lane.

Run on a machine with an NVIDIA GPU and the CUDA toolkit:

    python -m mppi_robotarm_tpu_torch.tools.sanitize [--tool racecheck ...]
        [--case k1-c8-prng ...] [--timeout 600]

It prints one line per run with the tool's error summary, and exits non-zero
when a run reports an error, fails, or the tool is missing or does not
support the device (it then says so and stops).  ``--run CASE``
runs one case in this process (what each sanitizer run executes).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

TOOLS = ("racecheck", "synccheck", "memcheck")
STEPS = 8
CASES = (
    *(f"k1-c{c}-{n}" for c in (2, 4, 8) for n in ("eps", "prng")),
    *(f"k3-{k}-{n}" for k in (128, 90) for n in ("eps", "prng")),
    "k2-1024", "k2-65536", "k2-1024-b64",
)
_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) error")
UNSUPPORTED = "Device not supported"


def sanitizer_path() -> str | None:
    """compute-sanitizer on PATH or in /usr/local/cuda, else None."""
    path = shutil.which("compute-sanitizer")
    cuda = "/usr/local/cuda/bin/compute-sanitizer"
    return path or (cuda if os.path.exists(cuda) else None)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tool", nargs="+", choices=TOOLS, default=list(TOOLS))
    ap.add_argument("--case", nargs="+", choices=CASES, default=list(CASES))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds allowed for each sanitizer run")
    ap.add_argument("--run", choices=CASES,
                    help="run one case in this process, unsanitized")
    return ap.parse_args(argv)


def commands(sanitizer: str, tools, cases):
    """[(tool, case, argv)] of the sanitizer runs, tools outermost."""
    return [(tool, case,
             [sanitizer, "--tool", tool, "--error-exitcode", "9",
              sys.executable, "-m", "mppi_robotarm_tpu_torch.tools.sanitize",
              "--run", case])
            for tool in tools for case in cases]


def summary(output: str) -> int | None:
    """The error count of a compute-sanitizer run's summary line."""
    m = _SUMMARY.search(output)
    return int(m.group(1)) if m else None


def run_case(case: str) -> None:
    """One short launch of the case's kernel on cuda:0, synchronised."""
    import dataclasses

    import numpy as np
    import torch

    import mppi_robotarm_tpu_torch as m
    from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve

    device = torch.device("cuda", 0)
    arm, cfg, sim = m.benchmark_preset()
    kind, *rest = case.split("-")
    if kind in ("k1", "k3"):
        setting, noise = rest
        if kind == "k3":
            cfg = dataclasses.replace(cfg, num_samples=int(setting),
                                      horizon=30)
        B = 1 if kind == "k1" else 16
        ref = torch.as_tensor(m.synth_circle_path(2000)[:400], device=device)
        wp = torch.zeros(B, dtype=torch.int64, device=device)
        wp[1::2] = ref.shape[0] - 1          # frozen from the start
        q0 = torch.tensor([sim.q0] * B, device=device)
        eps = None
        if noise == "eps":
            rng = np.random.default_rng(0)
            eps = torch.as_tensor(
                (rng.normal(size=(B, STEPS, cfg.num_samples, cfg.horizon, 2))
                 * np.sqrt(20.0)).astype(np.float32), device=device)
        kw = ({"cluster": int(setting[1:])} if kind == "k1"
              else {"group": 8})
        cuda_sim.fused_sim_run_batched(
            arm, cfg, sim, ref, q0, torch.zeros(B, 2, device=device),
            torch.tensor(cfg.warm_start, device=device).repeat(
                B, cfg.horizon, 1).contiguous(), wp,
            torch.arange(B, device=device), STEPS, eps=eps, **kw)
    else:
        cfg = dataclasses.replace(cfg, num_samples=int(rest[0]))
        W, T = cfg.search_idx_len, cfg.horizon
        B = 64 if rest[1:] == ["b64"] else 1
        ref = torch.as_tensor(m.synth_circle_path(2000), device=device)
        cuda_solve.solve_batched(
            arm, cfg,
            torch.tensor([[*sim.q0, 0.1, -0.2]] * B, device=device),
            torch.tensor(cfg.warm_start, device=device).repeat(B, T, 1),
            ref[None, :W].repeat(B, 1, 1).contiguous(),
            seed=torch.arange(B, device=device) + 3,
            step=torch.full((B,), 5, device=device), fuse_update=True)
    torch.cuda.synchronize()


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.run:
        run_case(a.run)
        return 0
    sanitizer = sanitizer_path()
    if sanitizer is None:
        print("sanitize: compute-sanitizer not found", file=sys.stderr)
        return 1
    bad = 0
    for tool, case, cmd in commands(sanitizer, a.tool, a.case):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=a.timeout)
            out, rc = r.stdout + r.stderr, r.returncode
        except subprocess.TimeoutExpired:
            out, rc = "", "timeout"
        if UNSUPPORTED in out:
            print(f"sanitize {tool} {case}: compute-sanitizer reports "
                  f"'{UNSUPPORTED}' on this machine; no case can run",
                  flush=True)
            return 2
        errors = summary(out)
        ok = rc == 0 and errors == 0
        bad += not ok
        print(f"sanitize {tool} {case}: rc {rc}, errors {errors}"
              + ("" if ok else "\n" + "\n".join(out.splitlines()[-40:])),
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
