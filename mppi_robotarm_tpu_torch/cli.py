"""Command-line interface of the PyTorch/CUDA port.

Runs the closed-loop tracking simulation, prints a JSON summary, and
optionally saves records, figures and checkpoints; the flags, file names
and summary keys are those of ``python -m mppi_robotarm_tpu.cli``, with the
backends named for this package:

    python -m mppi_robotarm_tpu_torch.cli --steps 1500 --backend cuda-fused \
        --out-dir results/ --figures
    python -m mppi_robotarm_tpu_torch.cli --batch 4096 --samples 128 \
        --horizon 30 --steps 2000 --backend cuda-fused
    python -m mppi_robotarm_tpu_torch.cli --steps 5 --backend eager \
        --device cpu

``cuda`` (the default: the per-step solve kernels, the counterpart of the
JAX CLI's per-step ``xla`` default), ``cuda-fused`` (the whole loop in
one kernel; with ``--batch`` the scenario-fleet kernel) and ``eager``
(batched PyTorch, replayed as CUDA graphs on the card) run on ``cuda:0``
and exit with a message when there is no CUDA device; ``--device cpu``
runs any of them on the CPU (the kernels' plain versions), where the JAX
CLI takes its platform from ``JAX_PLATFORMS``.  Configs load from JSON
(``--config``) on top of the circle-tracking preset; individual flags
override.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

BACKENDS = ("eager", "cuda", "cuda-fused")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mppi_robotarm_tpu_torch",
        description="MPPI path tracking for the 2-link arm, PyTorch/CUDA",
    )
    p.add_argument("--ref-path", default=None,
                   help="4/6-col path file; default: synthesised circle")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--steps", type=int, default=None,
                   help="closed-loop steps (default from SimConfig: 1500)")
    p.add_argument("--samples", type=int, default=None, help="K")
    p.add_argument("--horizon", type=int, default=None, help="T")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=BACKENDS, default="cuda",
                   help="batched eager PyTorch, the per-step CUDA solve "
                        "kernels (default), or the whole-loop fused CUDA "
                        "kernel (fastest; with --batch it runs the "
                        "scenario-fleet kernel; no --checkpoint-every)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda:0 (default; exits without a CUDA device) or "
                        "the CPU, where the kernels' plain versions run")
    p.add_argument("--out-dir", default=None,
                   help="save records (.npz), metrics (.json), figures")
    p.add_argument("--figures", action="store_true",
                   help="write reference-parity result figures")
    p.add_argument("--checkpoint", default=None,
                   help="resume from this checkpoint; also saved at the end")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="periodic checkpoint cadence in steps (0 = off)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace into this dir")
    p.add_argument("--metrics-every", type=int, default=100)
    p.add_argument("--batch", type=int, default=0,
                   help="run B parallel scenarios with seeds seed..seed+B-1 "
                        "and initial states jittered by 0.01·N(0, 1) drawn "
                        "from a torch.Generator seeded seed+1 (not the JAX "
                        "package's jax.random draw); saves all scenarios' "
                        "records; --figures draws scenario 0; --checkpoint "
                        "saves the final batched state; --checkpoint-every "
                        "and --render-step are not supported in batch mode")
    p.add_argument("--render-step", type=int, default=None,
                   help="after the run, render the sampled/optimal "
                        "trajectories at this recorded step (the reference's "
                        "run.py:73-118 per-step figure); requires --out-dir")
    return p


def _device(backend: str, device: str):
    import torch

    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"--backend {backend} needs a CUDA device and "
                         f"none is available (pass --device cpu to run on "
                         f"the CPU)")
    return torch.device("cuda", 0)


def _save_figures(out_dir, rec, ref) -> None:
    from .utils.plotting import plot_results

    fig1, fig2 = plot_results(rec, ref)
    fig1.savefig(os.path.join(out_dir, "figure1_tracking.png"), dpi=150)
    fig2.savefig(os.path.join(out_dir, "figure2_controls.png"), dpi=150)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from . import config as cfg_mod
    from .convert import records_to_numpy
    from .sim.loop import SimRecord, init_sim, simulate
    from .sim.paths import load_ref_path, synth_circle_path
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import MetricsLogger, tracking_errors
    from .utils.timing import trace

    device = _device(args.backend, args.device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    if args.config:
        with open(args.config) as f:
            arm, mppi, sim = cfg_mod.config_from_json(f.read())
    else:
        arm, mppi, sim = cfg_mod.circle_tracking_preset()
    if args.samples:
        mppi = dataclasses.replace(mppi, num_samples=args.samples)
    if args.horizon:
        mppi = dataclasses.replace(mppi, horizon=args.horizon)
    steps = args.steps if args.steps is not None else sim.num_steps

    ref = (load_ref_path(args.ref_path) if args.ref_path
           else synth_circle_path(max(2000, steps + mppi.search_idx_len + 2)))
    ref_t = torch.as_tensor(ref, device=device)

    if args.batch > 0:
        from .sim.loop import (init_sim_batch, simulate_batch,
                               simulate_fused_batch)

        # fail loudly on flags the batch branch cannot honour rather than
        # silently ignoring them after an expensive run
        if args.checkpoint_every > 0:
            raise SystemExit("--checkpoint-every is not supported with "
                             "--batch (use --checkpoint for a final save)")
        if args.render_step is not None:
            raise SystemExit("--render-step is not supported with --batch")
        gen = torch.Generator().manual_seed(args.seed + 1)
        q0 = (torch.tensor([sim.q0], dtype=torch.float32)
              + 0.01 * torch.randn((args.batch, 2), generator=gen))
        states = init_sim_batch(mppi, sim,
                                np.arange(args.seed, args.seed + args.batch),
                                q0=q0, device=device)
        t0 = time.perf_counter()
        with trace(args.profile_dir):
            if args.backend == "cuda-fused":
                # the whole B-scenario fleet in one kernel launch per chunk
                final, recb = simulate_fused_batch(arm, mppi, sim, ref_t,
                                                   states, steps)
            else:
                final, recb = simulate_batch(arm, mppi, sim, ref_t, states,
                                             steps, backend=args.backend)
            sync()
        wall = time.perf_counter() - t0
        ee_last = recb.ee[-1].cpu().numpy()
        err = np.linalg.norm(
            ee_last - ref[min(steps, ref.shape[0] - 1), 0:2], axis=-1)
        print(json.dumps({
            "batch": args.batch, "steps": steps, "K": mppi.num_samples,
            "T": mppi.horizon, "backend": args.backend,
            "wall_s": round(wall, 3),
            "scenario_solves_per_s": round(args.batch * steps / wall, 1),
            "ee_median_m": round(float(np.median(err)), 6),
            "ee_p95_m": round(float(np.percentile(err, 95)), 6),
        }))
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            recb = records_to_numpy(recb)
            np.savez(os.path.join(args.out_dir, "batch_record.npz"),
                     **recb._asdict())
            if args.figures:
                # scenario 0's view of the (steps, B, ...) record arrays
                _save_figures(args.out_dir,
                              SimRecord(*(v[:, 0] for v in recb)), ref)
        if args.checkpoint:
            save_checkpoint(args.checkpoint, final)
        return 0

    if args.checkpoint and os.path.exists(args.checkpoint):
        state = load_checkpoint(args.checkpoint, dtype=torch.float32,
                                device=device)
        print(f"resumed from {args.checkpoint} at step {int(state.step)}",
              file=sys.stderr)
    else:
        state = init_sim(mppi, sim, seed=args.seed, device=device)
    state0 = state                     # kept for --render-step replay
    per_step = "cuda" if args.backend == "cuda" else "eager"

    logger = MetricsLogger(every=args.metrics_every)
    t0 = time.perf_counter()
    with trace(args.profile_dir):
        if args.backend == "cuda-fused":
            from .sim.loop import simulate_fused
            if args.checkpoint_every > 0:
                raise SystemExit(
                    "--backend cuda-fused does not support "
                    "--checkpoint-every (the loop runs as one kernel)")
            state, rec = simulate_fused(arm, mppi, sim, ref_t, state, steps)
        elif args.checkpoint_every > 0:
            rec_parts = []
            done_steps = 0
            while done_steps < steps:
                chunk = min(args.checkpoint_every, steps - done_steps)
                state, rec = simulate(arm, mppi, sim, ref_t, state, chunk,
                                      backend=per_step)
                rec_parts.append(rec)
                done_steps += chunk
                if args.checkpoint:
                    save_checkpoint(args.checkpoint, state)
            rec = SimRecord(*(torch.cat(f) for f in zip(*rec_parts)))
        else:
            state, rec = simulate(arm, mppi, sim, ref_t, state, steps,
                                  backend=per_step)
        sync()
    wall = time.perf_counter() - t0

    # clamp the comparison window to the path length: a user-supplied
    # --ref-path shorter than steps+1 rows must not crash the error calc
    # after the whole simulation completed
    usable = min(steps, ref.shape[0] - 1)
    rec_np = records_to_numpy(rec)
    errs = tracking_errors(rec_np.ee[:usable], ref[1:usable + 1, 0:2],
                           full_path=ref)
    summary = {
        "steps": steps, "K": mppi.num_samples, "T": mppi.horizon,
        "backend": args.backend,
        "wall_s": round(wall, 3),
        "solves_per_s": round(steps / wall, 1),
        **{k: round(v, 6) for k, v in errs.items()},
        "final_wp_idx": int(state.mppi.wp_idx),
        "path_end": bool(state.done),
    }
    logger.log_record(rec, stride=args.metrics_every)
    print(json.dumps(summary))

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        np.savez(os.path.join(args.out_dir, "record.npz"), **rec_np._asdict())
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        if args.figures:
            _save_figures(args.out_dir, rec_np, ref)
        if args.render_step is not None:
            _render_step(args, arm, mppi, sim, ref, ref_t, state0, steps,
                         per_step)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)
    return 0


def _render_step(args, arm, mppi, sim, ref, ref_t, state0, steps, backend):
    """Replay the run up to step i with the per-step loop (the fused loop
    draws the same Philox stream), then re-solve step i on that step's
    noise and render its sampled and optimal trajectories."""
    import torch

    from .mppi.solver import solve, viz_rollouts
    from .ops.cuda_rollout import philox_epsilon
    from .sim.loop import simulate
    from .utils.plotting import plot_sampled_trajectories

    i = min(args.render_step, steps - 1)
    state_i = state0
    if i > 0:
        state_i, _ = simulate(arm, mppi, sim, ref_t, state0, i,
                              backend=backend)
    obs = torch.cat([state_i.q, state_i.dq])
    eps = philox_epsilon(state_i.seed, int(state_i.step), mppi,
                         state_i.q.device)
    res = solve(arm, mppi, ref_t, obs, state_i.mppi, eps=eps,
                backend=backend)
    viz = viz_rollouts(arm, mppi, obs, res.u_seq, state_i.mppi.u_prev,
                       res.eps, res.costs)
    fig = plot_sampled_trajectories(obs[:2], viz.sampled_trajs,
                                    viz.optimal_traj, ref, viz.sorted_idx)
    fig.savefig(os.path.join(args.out_dir, f"sampled_step{i}.png"), dpi=150)


if __name__ == "__main__":
    raise SystemExit(main())
