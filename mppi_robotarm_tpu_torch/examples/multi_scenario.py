"""Example: thousands of parallel tracking scenarios on one GPU
(BASELINE config 4), each scenario's whole loop in one kernel launch.

    python -m mppi_robotarm_tpu_torch.examples.multi_scenario [--batch B]
        [--samples K] [--steps N] [--device cuda|cpu]

``simulate_fused_batch`` runs the fleet kernel at K <= 128 and the fused
kernel above it; on the CPU their plain PyTorch versions run (slowly: use
small sizes there).
"""

import argparse
import dataclasses

import numpy as np
import torch

import mppi_robotarm_tpu_torch as m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    arm, cfg, sim = m.circle_tracking_preset()
    cfg = dataclasses.replace(cfg, num_samples=a.samples)
    path = m.synth_circle_path(2000)
    q0 = (np.asarray([sim.q0])
          + 0.02 * np.random.default_rng(1).normal(size=(a.batch, 2)))
    states = m.init_sim_batch(cfg, sim, np.arange(a.batch),
                              q0=q0.astype(np.float32), device=a.device)
    ref = torch.as_tensor(path, device=states.q.device)
    final, rec = m.simulate_fused_batch(arm, cfg, sim, ref, states, a.steps)

    ee = rec.ee[-1].cpu().numpy()                  # (B, 2) at the last step
    err = np.linalg.norm(ee - path[a.steps, 0:2], axis=-1)
    print(f"B={a.batch} K={a.samples}: median EE error at step {a.steps}: "
          f"{np.median(err) * 1e3:.2f} mm; "
          f"p95 {np.percentile(err, 95) * 1e3:.2f} mm; "
          f"all finite: {np.all(np.isfinite(ee))}")
    return err


if __name__ == "__main__":
    main()
