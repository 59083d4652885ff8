"""Example: closed-loop circle tracking, the reference's run.py, on the port.

    python -m mppi_robotarm_tpu_torch.examples.track_circle [--steps N]
        [--backend cuda|eager|fused] [--device cuda|cpu] [--out DIR]

Runs the closed loop at the reference configuration (K=100, T=30) on the
reference circle path (the reference's file when present, else the
synthesised circle), prints tracking statistics, and saves the
reference-parity figures into ``--out``.  ``cuda`` is the per-step loop
on the solve kernel, ``fused`` the whole loop in one kernel launch,
``eager`` PyTorch.
"""

import argparse
import os

import numpy as np
import torch

import mppi_robotarm_tpu_torch as m
from mppi_robotarm_tpu_torch.utils.metrics import tracking_errors
from mppi_robotarm_tpu_torch.utils.plotting import plot_results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--backend", choices=("cuda", "eager", "fused"),
                    default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=".")
    a = ap.parse_args(argv)

    arm, cfg, sim = m.circle_tracking_preset()
    ref_file = "/root/reference/xydq_circle.txt"
    ref = (m.load_ref_path(ref_file) if os.path.exists(ref_file)
           else m.synth_circle_path(2000))
    state = m.init_sim(cfg, sim, seed=0, device=a.device)
    ref_t = torch.as_tensor(ref, device=state.q.device)
    if a.backend == "fused":
        final, rec = m.simulate_fused(arm, cfg, sim, ref_t, state, a.steps)
    else:
        final, rec = m.simulate(arm, cfg, sim, ref_t, state, a.steps,
                                backend=a.backend)

    errs = tracking_errors(rec.ee.cpu().numpy(), ref[1:a.steps + 1, 0:2])
    print({k: round(v * 1e3, 3) for k, v in errs.items()}, "(mm)")
    fig1, fig2 = plot_results(rec, ref)
    os.makedirs(a.out, exist_ok=True)
    fig1.savefig(os.path.join(a.out, "tracking.png"), dpi=130)
    fig2.savefig(os.path.join(a.out, "controls.png"), dpi=130)
    print("figures saved to", os.path.abspath(a.out))
    return errs


if __name__ == "__main__":
    main()
