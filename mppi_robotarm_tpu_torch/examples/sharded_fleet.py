"""Example: scenarios and samples sharded over a ('data', 'samples') mesh
of processes (``parallel/``).

    torchrun --nproc-per-node N -m \\
        mppi_robotarm_tpu_torch.examples.sharded_fleet [--batch B]
        [--steps N] [--device cuda|cpu]

Without torchrun it runs as one process, a mesh of one.  With an even
number of ranks the K sample axis is split over two of them ('samples'),
whose solves combine by all-reduce; the scenarios split over the rest
('data').  Then the zero-collective fleet: every rank runs its block of
scenarios' whole loops in one kernel launch.  Each rank prints its block's
results.  ``python -m mppi_robotarm_tpu_torch.parallel.dryrun`` starts
such ranks itself.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

import mppi_robotarm_tpu_torch as m
from mppi_robotarm_tpu_torch.models.arm import fk_full
from mppi_robotarm_tpu_torch.parallel.mesh import (initialize_multihost,
                                                   make_mesh)
from mppi_robotarm_tpu_torch.parallel.sharded import (make_sharded_fleet,
                                                      make_sharded_sim_step,
                                                      scenario_shard)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    initialize_multihost(device=a.device)       # a no-op for one process
    n = dist.get_world_size() if dist.is_initialized() else 1
    samples_ax = 2 if n % 2 == 0 else 1
    mesh = make_mesh(samples=samples_ax, device_type=a.device)
    rank = dist.get_rank()
    device = (torch.device("cuda", torch.cuda.current_device())
              if a.device == "cuda" else torch.device("cpu"))

    arm, cfg, sim = m.circle_tracking_preset()
    cfg = dataclasses.replace(cfg, num_samples=64 * samples_ax, horizon=12)
    step_fn = make_sharded_sim_step(arm, cfg, sim, mesh, backend="cuda")
    path = m.synth_circle_path(2000)
    ref = torch.as_tensor(path, device=device)
    st = scenario_shard(mesh, m.init_sim_batch(
        cfg, sim, np.arange(a.batch), device=device))
    q, dq, u, wp, step = (st.q, st.dq, st.mppi.u_prev, st.mppi.wp_idx,
                          st.step)
    t0 = time.perf_counter()
    for _ in range(a.steps):
        q, dq, u, wp, done, u0 = step_fn(ref, q, dq, u, wp, st.seed, step)
        step = step + torch.where(done, 0, 1)
    x1, y1, x2, y2 = fk_full(q[:, 0], q[:, 1], arm)
    ee = torch.stack([x2, y2], -1).cpu().numpy()
    d = np.linalg.norm(ee[:, None] - path[None, :, 0:2], axis=2).min(axis=1)
    print(f"rank {rank} of {n}, mesh {n // samples_ax}x{samples_ax} (data x "
          f"samples): {q.shape[0]} scenarios x {a.steps} steps in "
          f"{time.perf_counter() - t0:.2f} s; on-path EE error at the end: "
          f"median {np.median(d) * 1e3:.1f} mm, p95 "
          f"{np.percentile(d, 95) * 1e3:.1f} mm")

    # the zero-collective fleet: scenarios over every rank
    fleet_mesh = make_mesh(samples=1, device_type=a.device)
    cfg_f = dataclasses.replace(cfg, num_samples=128)
    fleet = make_sharded_fleet(arm, cfg_f, sim, fleet_mesh, a.steps)
    block = scenario_shard(fleet_mesh, m.init_sim_batch(
        cfg_f, sim, np.arange(a.batch), device=device))
    t0 = time.perf_counter()
    final, rec = fleet(ref, block)
    ok = bool(torch.isfinite(rec.q).all())
    print(f"rank {rank}: fleet (whole-loop kernel, no collectives) "
          f"{block.q.shape[0]} scenarios x {a.steps} steps in "
          f"{time.perf_counter() - t0:.2f} s, finite: {ok}")
    dist.destroy_process_group()
    return d, ok


if __name__ == "__main__":
    main()
