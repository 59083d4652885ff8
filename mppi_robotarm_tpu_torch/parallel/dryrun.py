"""Run the sharded programs on a (data, samples) mesh of real processes.

The counterpart of ``__graft_entry__.py::dryrun_multichip``: one
``torch.distributed`` process a rank, started and joined by this script,
each running the programs of ``parallel/sharded.py`` on its block and
writing its blocks to ``OUT/rank{r}.npz``:

    python -m mppi_robotarm_tpu_torch.parallel.dryrun --world N --data D \\
        --samples S --device cuda|cpu --out DIR [--size tiny|full] \\
        [--programs step-eager step-cuda step-plain fleet]

Programs (PRNG mode; every scenario's seed is its index):
  * ``step-eager`` / ``step-cuda`` — the sample-sharded closed-loop step
    (``make_sharded_sim_step``) on each backend, run for ``steps`` steps:
    per step the block's q, u0, wp_idx and done, and the final state;
  * ``step-plain`` — ``step-cuda`` with the step's head, rescale, finish
    and tail run as their plain versions (``plain=True``), the yardstick
    of ``step-cuda``'s bits on the card;
  * ``fleet`` — the data-sharded fleet (``make_sharded_fleet``): the
    block's records (all but the fields derived from q) and final state,
    and whether that state came back bit for bit from a
    ``save_checkpoint_dist`` / ``load_checkpoint_dist`` round trip.

Sizes: ``tiny`` is the JAX dry run's (``benchmark_preset`` at K = 8·S,
H = 5, 2·D scenarios, a 200-point circle, 3 steps; the fleet the same);
``full`` the published one: the step at ``benchmark_preset`` (K = 1024,
H = 50), one scenario a data rank, on ``synth_circle_path(2000)`` for
1500 steps, and the fleet of 4096 scenarios × K = 128, T = 30 (q0 as
:func:`fleet_q0` gives it) for 2000 steps.  Each rank also
stores µs a step (host clock, device synchronised), its 'samples'
all-reduces' µs a solve, the launches of the solve kernel and of the four
step kernels (``ops/cuda_step.py``'s head and tail,
``ops/cuda_shard.py``'s scale and finish) in the step's loop, and
whether it imported JAX.

On ``cuda`` the ranks share the machine's cards round robin; NCCL refuses
two ranks on one card, so they then talk over gloo (``parallel/mesh.py``).
The kernels are built here before the ranks start.  The ranks get a free
``localhost`` port; a rank that fails, or outlives ``TIMEOUT_S``, stops
them all and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np

PROGRAMS = ("step-eager", "step-cuda", "step-plain", "fleet")
# the kernels whose launches the step loop counts (see _launches)
LAUNCH_COUNTS = ("solve", "head", "scale", "finish", "tail")
FLEET_FIELDS = ("q", "dq", "u", "wp_idx", "done", "cost_min", "cost_mean",
                "ess", "weight_entropy")
TIMEOUT_S = 600.0       # seconds the ranks may take together


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--data", type=int, required=True)
    ap.add_argument("--samples", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--programs", nargs="+", choices=PROGRAMS,
                    default=list(PROGRAMS))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.data * a.samples != a.world:
        ap.error(f"--data {a.data} x --samples {a.samples} != --world "
                 f"{a.world}")
    return a


def problem(size: str, data: int, samples: int):
    """The set-ups of a size: (arm, sim, (cfg, path, B, steps) of the step,
    (cfg, path, B, steps) of the fleet), the paths as NumPy."""
    from ..config import benchmark_preset
    from ..sim.paths import synth_circle_path

    arm, cfg, sim = benchmark_preset()
    if size == "tiny":
        cfg = dataclasses.replace(cfg, num_samples=8 * samples, horizon=5)
        path = synth_circle_path(200)
        step = (cfg, path, 2 * data, 3)
        return arm, sim, step, step
    path = synth_circle_path(2000)
    fleet_cfg = dataclasses.replace(cfg, num_samples=128, horizon=30)
    return arm, sim, (cfg, path, data, 1500), (fleet_cfg, path, 4096, 2000)


def fleet_q0(size: str, B: int, sim) -> np.ndarray:
    """The fleet's initial joint angles (B, 2), float32: the preset's q0
    (tiny), or run.py:14's (1.1522, -1.2661) spread by 0.01·N(0, 1) from
    NumPy seed 9 (full; chip_smoke's fleet)."""
    if size == "tiny":
        return np.tile(np.asarray([sim.q0]), (B, 1)).astype(np.float32)
    q0 = (np.array([[1.1522, -1.2661]])
          + 0.01 * np.random.default_rng(9).normal(size=(B, 2)))
    return q0.astype(np.float32)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    """The kernels' launch counts now, by :data:`LAUNCH_COUNTS`' names."""
    from ..ops import cuda_shard, cuda_solve, cuda_step

    return dict(zip(LAUNCH_COUNTS, (
        cuda_solve.LAUNCHES, cuda_step.HEAD_LAUNCHES,
        cuda_shard.SCALE_LAUNCHES, cuda_shard.FINISH_LAUNCHES,
        cuda_step.TAIL_LAUNCHES)))


def step_program(arm, cfg, sim, mesh, backend: str, ref, states, steps: int,
                 reduce=None, plain: bool = False) -> dict:
    """``steps`` steps of ``make_sharded_sim_step`` on the block
    ``states``, PRNG mode: the absolute step advances while a scenario is
    live, as in ``simulate_batch``.  Returns the per-step rows (q, u0,
    wp_idx, done stacked over steps), the final dq, u_prev and step, the
    host seconds (device synchronised), the collective seconds and calls,
    and each kernel's launches in the loop (``{name}_launches`` for
    :data:`LAUNCH_COUNTS`: one of each a step on the card's cuda backend,
    none on the CPU or with ``plain``)."""
    import torch

    from .sharded import SamplesAllReduce, make_sharded_sim_step

    reduce = reduce or SamplesAllReduce(mesh, timed=True)
    step_fn = make_sharded_sim_step(arm, cfg, sim, mesh, backend=backend,
                                    reduce=reduce, plain=plain)
    q, dq, u, wp = (states.q, states.dq, states.mppi.u_prev,
                    states.mppi.wp_idx)
    step, done = states.step, states.done
    rows = {"q": [], "u0": [], "wp_idx": [], "done": []}
    launches = _launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        q, dq, u, wp, end, u0 = step_fn(ref, q, dq, u, wp, states.seed, step)
        done = done | end
        step = step + torch.where(done, 0, 1)
        for k, v in (("q", q), ("u0", u0), ("wp_idx", wp), ("done", done)):
            rows[k].append(v)
    _sync(q.device)
    seconds = time.perf_counter() - t0
    out = {k: torch.stack(v) for k, v in rows.items()}
    out.update(final_dq=dq, final_u_prev=u, final_step=step, seconds=seconds,
               collective_seconds=getattr(reduce, "seconds", 0.0),
               collective_calls=getattr(reduce, "calls", 0))
    out.update({f"{k}_launches": v - launches[k]
                for k, v in _launches().items()})
    return out


def run_rank(a) -> dict:
    """One rank: join the group, build the mesh, run the programs; returns
    the arrays it writes."""
    import torch
    import torch.distributed as dist

    from ..sim.loop import _state_tensors, init_sim_batch
    from ..utils.checkpoint import load_checkpoint_dist, save_checkpoint_dist
    from .mesh import (DATA_AXIS, SAMPLES_AXIS, axis_rank,
                       initialize_multihost, make_mesh)
    from .sharded import make_sharded_fleet, scenario_shard

    if a.device == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    initialize_multihost(device=a.device)
    mesh = make_mesh(a.data, a.samples, device_type=a.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if a.device == "cuda" else torch.device("cpu"))
    arm, sim, (cfg, path, B, steps), (fcfg, fpath, fB, fsteps) = problem(
        a.size, a.data, a.samples)
    out = {"data_rank": axis_rank(mesh, DATA_AXIS),
           "samples_rank": axis_rank(mesh, SAMPLES_AXIS)}
    for prog in a.programs:
        if prog == "fleet":
            ref = torch.as_tensor(fpath, device=device)
            states = scenario_shard(mesh, init_sim_batch(
                fcfg, sim, np.arange(fB), q0=fleet_q0(a.size, fB, sim),
                device=device))
            run = make_sharded_fleet(arm, fcfg, sim, mesh, fsteps)
            dist.barrier()
            t0 = time.perf_counter()
            final, rec = run(ref, states)
            _sync(device)
            out["fleet_us_per_launch_step"] = (
                (time.perf_counter() - t0) / fsteps * 1e6)
            for f in FLEET_FIELDS:
                out[f"fleet_{f}"] = getattr(rec, f)
            out["fleet_u_final"] = final.mppi.u_prev
            out["fleet_step"] = final.step
            ckpt = os.path.join(a.out, "fleet_checkpoint")
            save_checkpoint_dist(ckpt, final, mesh)
            back = load_checkpoint_dist(ckpt, mesh, device=device)
            out["fleet_checkpoint_bitwise"] = all(
                torch.equal(x, y) for x, y in zip(_state_tensors(back),
                                                  _state_tensors(final)))
            continue
        ref = torch.as_tensor(path, device=device)
        states = scenario_shard(mesh, init_sim_batch(
            cfg, sim, np.arange(B), device=device))
        dist.barrier()
        res = step_program(arm, cfg, sim, mesh,
                           "eager" if prog == "step-eager" else "cuda", ref,
                           states, steps, plain=prog == "step-plain")
        for k in ("q", "u0", "wp_idx", "done", "final_dq", "final_u_prev",
                  "final_step", *(f"{n}_launches" for n in LAUNCH_COUNTS)):
            out[f"{prog}_{k}"] = res[k]
        out[f"{prog}_us_per_step"] = res["seconds"] / steps * 1e6
        out[f"{prog}_collective_us_per_solve"] = (
            res["collective_seconds"] / steps * 1e6)
        out[f"{prog}_collectives_per_solve"] = res["collective_calls"] / steps
    out["jax_imported"] = "jax" in sys.modules
    dist.barrier()
    dist.destroy_process_group()
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(a) -> int:
    """Start the ranks, wait for them, stop them all if one fails."""
    if a.device == "cuda":
        from ..device import resolve_device
        from ..ops._build import load_library

        resolve_device("cuda")
        load_library()            # once, before the ranks load it
    os.makedirs(a.out, exist_ok=True)
    env = dict(os.environ, MPPI_COORDINATOR_ADDRESS=f"127.0.0.1:"
               f"{_free_port()}", MPPI_NUM_PROCESSES=str(a.world))
    base = [sys.executable, "-m", "mppi_robotarm_tpu_torch.parallel.dryrun",
            "--world", str(a.world), "--data", str(a.data), "--samples",
            str(a.samples), "--device", a.device, "--out", a.out, "--size",
            a.size, "--programs", *a.programs]
    procs = [subprocess.Popen(base + ["--rank", str(r)],
                              env=dict(env, MPPI_PROCESS_ID=str(r)))
             for r in range(a.world)]
    deadline = time.monotonic() + TIMEOUT_S
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                rc = failed[0].returncode if failed else 124
                break
            time.sleep(0.05)
        else:
            rc = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    print(f"dryrun: {a.world} ranks, mesh {a.data}x{a.samples} (data x "
          f"samples), {a.device}, {a.size}, {' '.join(a.programs)}: "
          + ("OK" if rc == 0 else f"failed ({rc})"), flush=True)
    return rc


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.rank is None:
        return launch(a)
    out = run_rank(a)
    path = os.path.join(a.out, f"rank{a.rank}.npz")
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
