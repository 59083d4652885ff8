"""Example: the reference's run.py driver, unchanged, on the compat layer.

    python -m mppi_robotarm_tpu_torch.examples.reference_drop_in [--steps N]
        [--backend cuda|eager] [--device cuda|cpu]

What a user of the reference writes after switching: the same host-side
closed loop as run.py:48-71 (plant Euler at dt=0.003, EE records), with
only the imports changed to ``mppi_robotarm_tpu_torch.compat``.  The MPPI
solve inside ``calc_control_input`` runs on the port's solver (the solve
kernel with ``--backend cuda``) instead of the reference's Python triple
loop.  The port's own drivers (``simulate``, ``simulate_fused``) keep the
loop on the device and are much faster.
"""

import argparse
import os

import numpy as np

# the reference's imports, redirected: the only change
from mppi_robotarm_tpu_torch.compat import (
    SYS_PARAMS,
    Arm_Dynamic,
    Forward_Kinemetic,
    MPPIControllerForPathTracking,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--backend", choices=("cuda", "eager"), default="cuda")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    params = SYS_PARAMS()
    if not params["l1"] == params["l2"] == 1:
        raise ValueError(f"the reference arm has unit links, got {params}")

    # run.py:10-19
    delta_t = 0.003
    q = np.array([1.1522, -1.2661])
    dq = np.zeros(2)
    ref_file = "/root/reference/xydq_circle.txt"
    if os.path.exists(ref_file):
        ref_path = np.loadtxt(ref_file)[:, 0:4]
    else:
        from mppi_robotarm_tpu_torch.sim.paths import synth_circle_path
        ref_path = synth_circle_path(2000)

    # run.py:25-37, the exact reference configuration
    np.random.seed(0)
    mppi = MPPIControllerForPathTracking(
        delta_t=delta_t * 2.0,
        ref_path=ref_path,
        horizon_step_T=30,
        number_of_samples_K=100,
        param_exploration=0.0,
        param_lambda=100.0,
        param_alpha=0.98,
        sigma=np.array([[20.0, 0.0], [0.0, 20.0]]),
        stage_cost_weight=np.array([0.5, 0.5, 5.0, 5.0]),
        terminal_cost_weight=np.array([5.0, 5.0, 50.0, 50.0]),
        visualize_optimal_traj=True,
        visualze_sampled_trajs=False,
        backend=a.backend, device=a.device,
    )

    err = []
    for k in range(a.steps):
        state = np.concatenate([q, dq])
        try:
            u, u_seq, optimal_traj, sampled = mppi.calc_control_input(
                observed_x=state)
        except IndexError:
            print(f"path end reached at step {k}")
            break
        # plant step (run.py:53-55): semi-implicit Euler at dt
        dq = dq + delta_t * Arm_Dynamic(q, dq, u)
        q = q + delta_t * dq
        _, _, x2, y2 = Forward_Kinemetic(q)
        err.append(np.hypot(x2 - ref_path[k + 1, 0],
                            y2 - ref_path[k + 1, 1]))

    err = np.asarray(err)
    print(f"{len(err)} steps; mean EE tracking error "
          f"{err.mean() * 1e3:.2f} mm, max {err.max() * 1e3:.2f} mm, "
          f"final wp idx {mppi.prev_waypoints_idx}")
    return err


if __name__ == "__main__":
    main()
