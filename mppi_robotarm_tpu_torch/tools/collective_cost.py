"""Cost the sample-sharded programs' collectives by A/B.

The counterpart of ``tools/collective_cost.py``: run the (1 x 2)
sample-sharded step (``make_sharded_sim_step(backend="cuda")``) and the
sample-sharded solve (``make_sharded_solve(backend="cuda")``) in two rank
processes, as ``parallel/dryrun.py`` runs them, each against its twin
without collectives (``SamplesAllReduce(elide=True)``: every shard keeps
its own values, a program that is the same in every shard-local launch but
exchanges nothing).  The difference is the collectives' cost; the twin's
own time is the program without them.

Each timed rep is a chain of ``--chain`` steps (solves) from the same
start state, the step feeding its state forward (the solve its u and
index); A and B reps alternate strictly, the ranks meeting at a barrier
before each, and the estimate is the median of the paired (with −
without) differences per step with its IQR as the noise bar.  When the
IQR straddles zero the honest claim is an upper bound: the collectives
cost less than the IQR's top.  Each rank also profiles one chain of the
step with its collectives (on the card): device events a step and device
µs a step by kernel.

    python -m mppi_robotarm_tpu_torch.tools.collective_cost \\
        [--device cuda|cpu] [--size full|tiny] [--pairs 24] [--chain 8] \\
        [--label NAME] [--out DIR]

It prints the card's name and power limit, a line per program and rank,
and one JSON line.  The rank processes run this file with the launcher's
package first on ``PYTHONPATH``, so ``PYTHONPATH=<tree> python
mppi_robotarm_tpu_torch/tools/collective_cost.py`` measures another
tree's package (one that has ``parallel/``).  ``--size full`` is
benchmark_preset (K = 1024, H = 50) at one scenario on
``synth_circle_path(2000)``, K_local = 512 a rank; ``tiny`` the dry run's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

PROGRAMS = ("step", "solve")
TIMEOUT_S = 900.0       # seconds the ranks may take together


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--size", choices=("tiny", "full"), default="full")
    ap.add_argument("--pairs", type=int, default=24)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None,
                    help="directory of the ranks' results (default: "
                         "build/collective_cost under the package's tree)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def paired(t_with, t_without) -> dict:
    """The A/B statistics of per-step seconds: medians of each side, the
    median paired difference with its IQR (µs), whether the IQR excludes
    zero, and otherwise the IQR's top as an upper bound."""
    d = (np.asarray(t_with) - np.asarray(t_without)) * 1e6
    q1, q3 = np.percentile(d, [25, 75])
    resolved = bool(q1 > 0 or q3 < 0)
    return {"us_with": float(np.median(t_with) * 1e6),
            "us_without": float(np.median(t_without) * 1e6),
            "collective_cost_us_median": float(np.median(d)),
            "iqr_us": [float(q1), float(q3)], "resolved": resolved,
            "upper_bound_us": None if resolved else float(q3)}


def _profile(run, device) -> tuple:
    """(device events a call, {kernel: device µs a call}) of ``run()`` by
    ``torch.profiler``; on the CPU (None, {})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None, {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        calls = run()
        torch.cuda.synchronize(device)
    events = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    us = {}
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            us[e.key] = t / calls
    return events / calls, us


def run_rank(a) -> dict:
    """One rank: join the group, build the programs, time the A/B pairs."""
    import torch
    import torch.distributed as dist

    import mppi_robotarm_tpu_torch as pkg
    from mppi_robotarm_tpu_torch.parallel import dryrun
    from mppi_robotarm_tpu_torch.parallel.mesh import (initialize_multihost,
                                                       make_mesh)
    from mppi_robotarm_tpu_torch.parallel.sharded import (
        SamplesAllReduce, make_sharded_sim_step, make_sharded_solve,
        scenario_shard)
    from mppi_robotarm_tpu_torch.sim.loop import init_sim_batch

    if a.device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(device=a.device)
    mesh = make_mesh(1, 2, device_type=a.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if a.device == "cuda" else torch.device("cpu"))
    arm, sim, (cfg, path, B, _), _ = dryrun.problem(a.size, 1, 2)
    ref = torch.as_tensor(path, device=device)
    st = scenario_shard(mesh, init_sim_batch(cfg, sim, np.arange(B),
                                             device=device))
    k_local = cfg.num_samples // 2
    rank = dist.get_rank()
    eps = torch.as_tensor((np.random.default_rng(rank).normal(
        size=(B, k_local, cfg.horizon, 2)) * np.sqrt(20.0)).astype(
        np.float32), device=device)
    obs = torch.cat([st.q, st.dq], dim=-1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step_chain(fn):
        q, dq, u, wp = st.q, st.dq, st.mppi.u_prev, st.mppi.wp_idx
        step, done = st.step, st.done
        for _ in range(a.chain):
            q, dq, u, wp, end, _ = fn(ref, q, dq, u, wp, st.seed, step)
            done = done | end
            step = step + torch.where(done, 0, 1)
        return a.chain

    def solve_chain(fn):
        u, wp = st.mppi.u_prev, st.mppi.wp_idx
        for _ in range(a.chain):
            out = fn(ref, obs, u, wp, eps)
            u, wp = out[2], out[3]
        return a.chain

    def programs(elide):
        red = SamplesAllReduce(mesh, elide=elide)
        step = make_sharded_sim_step(arm, cfg, sim, mesh, backend="cuda",
                                     reduce=red)
        solve = make_sharded_solve(arm, cfg, mesh, backend="cuda",
                                   reduce=red)
        return {"step": lambda: step_chain(step),
                "solve": lambda: solve_chain(solve)}

    with_c, without_c = programs(False), programs(True)
    out = {"rank": rank, "package": os.path.dirname(pkg.__file__), "B": B,
           "K": cfg.num_samples, "K_local": k_local, "T": cfg.horizon}

    def timed(run):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        n = run()
        sync()
        return (time.perf_counter() - t0) / n

    for prog in PROGRAMS:
        timed(with_c[prog])                  # builds, allocates, warms up
        timed(without_c[prog])
        t_with, t_without = [], []
        for _ in range(a.pairs):             # strictly interleaved A/B
            t_with.append(timed(with_c[prog]))
            t_without.append(timed(without_c[prog]))
        out[prog] = paired(t_with, t_without)
    dist.barrier()
    out["events_per_step"], out["device_us_per_step"] = _profile(
        with_c["step"], device)
    dist.barrier()
    dist.destroy_process_group()
    return out


def launch(a) -> dict:
    """Start the two ranks on this file, with the package this process
    imports first on their path; wait; return rank 0's and rank 1's
    results.  Stops both and raises if one fails or they outlive
    ``TIMEOUT_S``."""
    import mppi_robotarm_tpu_torch as pkg
    from mppi_robotarm_tpu_torch.parallel.dryrun import _free_port

    tree = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    out = a.out or os.path.join(tree, "build", "collective_cost")
    if a.device == "cuda":
        from mppi_robotarm_tpu_torch.ops._build import load_library

        load_library()                 # once, before the ranks load it
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, MPPI_COORDINATOR_ADDRESS=f"127.0.0.1:"
               f"{_free_port()}", MPPI_NUM_PROCESSES="2",
               PYTHONPATH=os.pathsep.join(
                   [tree] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    base = [sys.executable, os.path.abspath(__file__), "--device", a.device,
            "--size", a.size, "--pairs", str(a.pairs), "--chain",
            str(a.chain), "--out", out]
    procs = [subprocess.Popen(base + ["--rank", str(r)],
                              env=dict(env, MPPI_PROCESS_ID=str(r)))
             for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"collective_cost: the ranks exited {rcs}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.rank is not None:
        res = run_rank(a)
        path = os.path.join(a.out, f"rank{a.rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(path + ".tmp", path)
        return 0
    where = "cpu"
    if a.device == "cuda":
        import torch

        from mppi_robotarm_tpu_torch.tools.fused_timing import card

        if not torch.cuda.is_available():
            print("collective_cost: no CUDA device", file=sys.stderr)
            return 1
        where = card()
    print(where)
    ranks = launch(a)
    r0 = ranks[0]
    print(f"the ranks ran {r0['package']}")
    # a solve's all-reduces: MIN on m (B floats) and SUM on the packed
    # [η, A] message (B (1 + 2T) floats)
    payload = 4 * r0["B"] * (2 + 2 * r0["T"])
    for prog in PROGRAMS:
        for z in ranks:
            s = z[prog]
            tag = ("" if s["resolved"] else
                   f"  (below the noise: a bound, < {s['upper_bound_us']:.1f}"
                   f" us)")
            print(f"{a.label or 'tree'} {prog} rank {z['rank']} [{where}]: "
                  f"{s['us_with']:.1f} us a {prog} with the collectives, "
                  f"{s['us_without']:.1f} without; the collectives "
                  f"{s['collective_cost_us_median']:+.1f} us (IQR "
                  f"[{s['iqr_us'][0]:+.1f}, {s['iqr_us'][1]:+.1f}]){tag}")
    for z in ranks:
        if z["events_per_step"] is not None:
            top = sorted(z["device_us_per_step"].items(),
                         key=lambda kv: -kv[1])
            print(f"rank {z['rank']}: {z['events_per_step']:.1f} device "
                  f"events a step; device us a step: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in top))
    print(json.dumps({
        "tool": "collective_cost", "label": a.label, "card": where,
        "package": r0["package"], "mesh": [1, 2], "B": r0["B"],
        "K": r0["K"], "K_local": r0["K_local"], "T": r0["T"],
        "payload_bytes_per_solve": payload, "pairs": a.pairs,
        "chain": a.chain,
        "rows": [dict(program=prog, rank=z["rank"], **z[prog])
                 for prog in PROGRAMS for z in ranks],
        "events_per_step": [z["events_per_step"] for z in ranks],
        "device_us_per_step": [z["device_us_per_step"] for z in ranks]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
