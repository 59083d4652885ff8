#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

Run from the root of a checkout, on a machine with an NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the device, its power limit, and the kernel build (nvcc's ptxas report);
  2. eps mode: the fused kernel against its plain PyTorch twin on the same
     injected noise, 8 steps, at benchmark_preset (K=1024, H=50) on the
     8000-point circle and at the reference config (K=100, H=30);
  3. PRNG mode: the same comparison with the kernel's Philox stream;
  4. the fused path, ``simulate_fused(benchmark_preset, seed 0, 4000 steps)``
     on the cluster size that ``cuda_sim.cluster_size`` chooses (> 1 at
     B=1): the kernel's launch count, finite records, >= 1000 live steps,
     the on-path mean over the first 1500 live steps < 42 mm, and
     high_accuracy_preset < 18 mm; its records and u_final == those of
     ``fused_sim_run(..., cluster=1)`` bit for bit, and so are every other
     cluster size's that fits: over the 4000 steps, in eps mode over 8 steps
     at benchmark_preset and at K=100, T=30 (C <= 4), and over 50 steps of
     K=8192, H=50;
  5. continuation: 2000 + 2000 chained steps equal one 4000-step run;
  6. timing with CUDA events, min of 3 in turns (``tools/fused_timing.py``):
     the kernel over the 4000-step run at every cluster size, with the
     SHA-256 of each run's records and u_final, and the plain twin over 20
     steps, at the benchmark shape;
  7. the solve kernel against its plain twin, eps and PRNG modes, at
     K=1024/H=50 (B=1 and B=64: four tiles a block, eight blocks a
     scenario), K=100/T=30 (B=8), K=65536/H=50 (B=1) and phase 9's fused
     solve at K=128/T=30 (B=4096), and raw rows with k_offset: S and m bit
     for bit, Σwε / u_new within 2e-5, η within 2e-5 relative, PRNG noise
     == the twin's bit for bit and == philox_epsilon for up to 8 scenarios,
     two runs the same bits;
  8. the per-step path, ``simulate(benchmark_preset, seed 0, 4000 steps,
     backend="cuda")``, which replays CUDA graphs of
     ``sim/loop.py::_GRAPH_STEPS`` steps: one solve-kernel launch a step
     (so at least one a live step), one step tail (``ops/cuda_step.py``)
     a step, one step head a chunk and the other steps' heads carried by
     the tails, and no separate combine launch, finite
     records, on-path mean < 42 mm, records and final state == the eager
     chunked loop's (``sim/loop.py::_step_loop(graphs=False)``) bit for
     bit, its first 8 steps == phase 4's fused run within the bands of
     phase 2;
  9. the batch, ``simulate_batch(backend="cuda")`` at 4096 scenarios x
     K=128, T=30 for 50 steps: finite records, scenario 0 == its run alone
     bit for bit; its peak device memory;
 10. timing: the solve kernel's one launch, its device time
     (torch.profiler) and CUDA-event time per solve against the plain twin
     at K=1024 and K=65536 (B=1) and at phase 9's per-step solve (4096 x
     K=128, T=30), each with the layout that ``cuda_solve.solve_layout``
     picks (the tile from K, the lanes a sample and tiles a block from the
     batch and the card's SMs), the
     per-step loop's µs/step and device idle share (device-busy µs/step
     from a profiled window against the unprofiled µs/step) as replayed
     graphs beside the eager chunked loop's, in turns, with the graphs'
     length and capture seconds and a step's device split (the solve, the
     step head, the step tail carrying the next head, copies, other
     kernels), the batch's scenario-steps/s and µs/step; the step kernels'
     plain versions per call at benchmark_preset;
 11. the fleet kernel against the fused kernel and against its plain
     twin, eps and PRNG modes: K=128/T=30, B=64, group=8 on a 120-row
     path with half the scenarios frozen from the start, K=100/T=30,
     B=12, group=4, and at odd horizons K=20/T=31 (one padded slot, half
     frozen) and K=90/T=25, B=16, group=8: records and u_final == the
     fused kernel's bit for bit
     over 50 steps, two runs the same bits, within phase 2's bands of
     ``fused_sim_reference_stacked`` over 8 steps;
 12. the fleet path, ``simulate_fused_batch`` on phase 9's fleet for 2000
     steps: fleet-kernel launches, finite records, scenario 0 ==
     ``simulate_fused`` of it alone bit for bit, every scenario == the
     fused kernel's run of the fleet (group 1), 1000 + 1000 chained steps
     == one run, the first 8 steps of scenario 0 within phase 2's bands of
     phase 9's ``simulate_batch(backend="cuda")``; the on-path mean over
     scenarios (median and p95, not gated); its peak device memory;
 13. the CLI in-process: ``--batch 4096 --backend cuda-fused`` (fleet
     kernel), single ``--backend cuda-fused`` (fused kernel), and
     ``--backend cuda --checkpoint-every`` against a checkpoint and resume,
     which must equal the uninterrupted run;
 14. the fleet kernel's layout (``cuda_sim.fleet_warps``: warps a
     scenario, samples a lane, scenarios a block) and its rollout loop's
     local loads and stores in the built library's SASS; timing with CUDA
     events, min of 3, over 1000 steps of phase 9's fleet: the fleet kernel
     against the fused kernel (their records and u_final equal for every
     scenario), and the stacked plain twin per step; the
     fleet kernel within phase 2's bands of the stacked twin over 8 steps
     of every scenario;
 15. the launch-overhead probes: ``probe_scale_kernel`` (P1) and
     ``probe_big_kernel`` (P2, one block an SM) against their plain
     versions bit for bit (P2 also at a size its threads do not divide),
     then ``tools/overhead.py``'s five chains of 100 iterations (a
     torch op, P1, P2, the solve at K=1024, H=50 with and without the noise
     output), each eager and as one replayed CUDA graph, the graph's final
     carry equal to the eager chain's bit for bit; the probes' device time
     beside their plain versions' and, for P1, ``torch.mul``'s;
 16. the sample-sharded solve in one process: K=1024, H=50 at B=1 and 8 cut
     into 2 and 4 launches of the solve kernel with ``k_offset`` and
     ``normalize=False``, combined by ``parallel/sharded.py::
     combine_partials``, against one unsharded launch, eps and PRNG modes:
     S and m bit for bit, Σwε and u_new within 2e-5, η within 2e-5
     relative;
 17. real 2-process runs on cuda:0 over gloo through ``parallel/dryrun.py``
     (``--size full``): a (1 x 2) mesh runs the sample-sharded step
     (``make_sharded_sim_step(backend="cuda")``, PRNG: a step the step
     head, the solve kernel, MIN, ``shard_scale_kernel``, SUM,
     ``shard_finish_kernel`` and the step tail) at benchmark_preset on
     ``synth_circle_path(2000)`` for 1500 steps: both shards the same
     bits, one launch of each of the five kernels a step by rank (counted
     in the ranks), the rows (q, u0, wp_idx, done) and the final state
     bit for bit those of the same step through the step kernels' plain
     versions (``step-plain``), the first 8 steps within phase 2's bands
     of ``simulate(backend="cuda")``, on-path mean < 42 mm, µs/step and
     the all-reduces' µs a solve; a (2 x 1) mesh runs the fleet
     (``make_sharded_fleet``) on phase 12's 4096 x K=128, T=30 for 2000
     steps: each rank's records and final state == its rows of phase 12's
     unsharded run bit for bit, a ``save_/load_checkpoint_dist`` round trip
     bit for bit, µs per launch-step with both ranks on the card;
 18. the debug path: ``checked_solve(backend="cuda")`` clean mid-path,
     raising at the path end and on a NaN ``u_prev``; the graph loop under
     ``debug_mode`` (checks between chunks) == phase 8's records;
 19. ``generate_circle_path(2000)`` on cuda: one launch of
     ``pathgen_kernel`` (``csrc/pathgen_kernel.cu``) and no per-step torch
     loop (the call's device events, by the profiler, do not grow from
     2000 steps to 4000), against the CPU (x,
     y within 1e-6, dq 1e-5, u 1e-3) with its seconds; the kernel against
     its plain version (``ops/cuda_pathgen.py::pathgen_reference``) on the
     same card tensors in float32 and float64 (the same bands, max |d| by
     column, bitwise or not), the kernel's device time, the plain loop's on
     the card and on the CPU; and 20 steps of the compat
     layer's ``MPPIControllerForPathTracking`` on the solve kernel under
     ``np.random.seed(0)``: finite, on-path mean < 42 mm;
 20. the step kernels (``csrc/step_kernel.cu``: the head before a chunk's
     first solve, the tail after each solve, carrying the next step's
     head) against their plain versions on the same card tensors over 8
     steps of the per-step loop, the solve kernel between them, at
     benchmark_preset for B=1 on the 8000-point circle and for B=64 on its
     first 200 rows (spread indices, every 8th scenario frozen, four near
     the path end), and at phase 9's fleet shape (4096 x K=128, T=30, from
     phase 9's final state, every 8th scenario frozen, four near the path
     end: several scenarios a block, one statistics warp each), with the
     tail's layout (``cuda_step.step_tail_layout``) at each shape: the
     head kernel's outputs and, at
     every step, the head the tail carries equal to the plain head on the
     same state; the state, controls, index, done, FK, reference rows and
     min cost bit for bit, the mean cost, ESS and entropy within 2e-6
     relative, the entropy's relative to at least its range log K (the
     kernel's sums over K run in another order than torch's reductions,
     and a near-deterministic softmax has an entropy near 0), and equal
     to their order in torch (``cuda_step.tail_stats_ordered``) bit for
     bit;
 21. the sample-sharded step's kernels (``csrc/shard_kernel.cu``, the
     rescale before the SUM and the finish after it) and the step kernels
     around them against their plain versions on the same card tensors:
     8 steps of the step (head, the solve kernel on each of two shards of
     K_local 512 with k_offset, MIN, rescale, SUM, finish, tail) with the
     shards stacked in one process as phase 16 stacks them, at
     benchmark_preset for B=1 on the 8000-point circle and for B=64 on its
     first 200 rows (every 8th scenario at the last row, four near it),
     eps and PRNG modes, filter windows 1, 10 and 2T + 3: every output of
     every step bit for bit, one launch of each kernel a step; the two
     kernels' device time at B=1 beside their plain versions';
 22. BASELINE config 5 on one card: phase 9's fleet grown to 32,768
     scenarios (the same q0 stream, so its first 4096 scenarios are phase
     9's): ``simulate_fused_batch`` for 2000 steps (the fleet kernel, 63
     launches of at most 32 steps under the 2^20 scenario-step cap):
     records of shape (2000, 32768, .), finite but for scenarios that
     reach the path's closure rows (``synth_circle_path``'s θ≈2π
     overrides, where the index stops at a row whose dq is the override's
     jump) and diverge there, each of those == ``simulate_fused`` of it
     alone bit for bit (NaNs included), scenarios 0-4095 == phase 12's run
     bit for bit on every field and the final state, 8 scenarios spread
     over 4096-32767 == ``simulate_fused`` of each alone, 1000 + 1000
     chained == one run, the on-path mean over the finite scenarios
     (median, p95); the fleet kernel's µs per launch-step (CUDA events,
     min of 3 over 512 steps) beside phase 14's at 4096, the path's wall
     time and the 63 launches' time outside the kernel (profiler); the
     per-step path, ``simulate_batch(backend="cuda")`` for 50 steps:
     finite, one solve and one tail a step, a head a chunk, scenarios
     0-4095 == phase 9's run bit for bit, µs/step; the (2 x 1) data-sharded fleet
     (``parallel/dryrun.py --fleet-scenarios 32768``, 16,384 scenarios a
     rank, two ranks sharing the card over gloo, so no scaling number):
     each rank's records and final state == its rows of the fused run bit
     for bit, µs per launch-step by rank; each path's peak device memory;
 23. the soak (``tools/longrun.py``'s functions): 40,000 steps at
     benchmark_preset, seed 0, PRNG, on a 10-revolution
     ``synth_circle_path(36000, revolutions=10)``: the fused kernel in one
     launch, chained 4 x 10,000 (== the one launch bit for bit, records
     and final state), and the per-step graph loop (2500 chunks replayed):
     each finite, the path's end reached and then the state frozen with
     u and the cost lanes zeroed, the step counter == the live steps, the
     on-path mean over the first 1500 live steps < 42 mm (bench.py's
     gate); the whole run's on-path mean, the schedule agreement and the
     |q|, |u| envelope between the fused kernel and the graph loop, and
     each run's seconds, reported;
 24. the benchmark, ``python -m mppi_robotarm_tpu_torch.bench`` (the
     port of ``bench.py``: its three backends, the fit and the
     high-accuracy run) in a subprocess: exit 0, each backend's solves/s
     finite and > 0, its last line JSON with exactly bench.py's keys
     (``device_us_per_step`` when the fused backend wins), the value the
     winner's solves/s, the on-path mean < 42 mm and the high-accuracy
     one < 18 mm; its lines and its seconds printed;
 25. the solve kernel at ``tools/extreme_shapes.py``'s five stress shapes
     (K, T) = (65536, 50), (65536, 200), (8192, 500), (131072, 100) and
     (1024, 30): the layout and its shared memory, one
     ``solve(backend="cuda")`` finite in one launch, and the kernel
     against its plain version on the same inputs at lam = 3e5, injected
     ε and Philox: S and m bit for bit, u_new within 2e-5, η within 2e-5
     relative, the noise bit for bit; its device time beside its bound;
 26. the gate sweeps as a smoke: ``tools/bench_gate_sweep.py 2 bench``
     and ``tools/seed_sweep.py 2 200 cuda`` (their ``main``, in this
     process) exit 0 and print their spread and suggested gate;
 27. the eager backend on the card (``tools/eager_loop.py``):
     ``simulate_batch(backend="eager")`` replays each chunk of
     ``sim/loop.py::_EAGER_GRAPH_STEPS`` steps as one CUDA graph; its
     records and final state == the uncaptured eager loop's
     (``_step_loop(graphs=False, backend="eager")``) bit for bit at
     benchmark_preset in float32 over 200 steps and at K=128, T=30 in
     float64 over 50, and a 64-scenario batch at K=128, T=30 == each of
     its scenarios run alone over 50 steps, bit for bit (the sums over K
     run in an order fixed by K, ``ops/weights.py::ordered_sum``), the
     largest |d| by field printed; the eager path launches none of the
     port's kernels (every count 0 after it, from 0 before); the eager
     µs/step as graphs and uncaptured (CUDA events, min of 3 in turns)
     beside the host loop's 65.4 ms a step it replaced (PERF.md), the
     host's time to enqueue a step, the device events a step, the idle
     share, the chunk length and the capture seconds; 20 steps of the
     4096 x K=128, T=30 fleet on the eager backend, scenario-steps/s and
     device events a step.

The line before the last is the per-kernel JSON summary: each kernel's
launches on its main path, its error against its plain version, its time,
the plain version's, a library call's where one PyTorch call computes the
same function, and its bound, the least time the card could take for the
work (``bound_ms``): the larger of the operations over 67 TFLOP/s (the
H100 SXM's published float32 peak outside the tensor cores) and the bytes
over 3.35 TB/s (its HBM3), for the inputs of this run.  The bounds line
also prints each fused kernel's operations at the unfused float32 issue
rate, 33.5 T/s (132 SMs × 128 lanes × 1.98 GHz): the hand count counts an
add and a mul as two operations, as the peak counts an FMA, but the
build's ``--fmad=false`` fuses none, so each takes an issue slot.  That
figure is for reading the kernels; ``bound_ms`` stays at the card's peak.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script fails.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np

STEPS = 4000          # the benchmark's chain length
CMP_STEPS = 8         # kernel-vs-twin comparison length
Q_TOL, U_TOL = 2e-6, 2e-5          # step i: q within Q_TOL·4^i, u U_TOL·4^i
STATS_RTOL = 1e-4                  # stats lanes at step 0, relative
STEP_STATS_RTOL = 2e-6             # phase 20: the step tail's sums over K
ONPATH_GATE_MM = 42.0              # bench.py:160
HA_GATE_MM = 18.0                  # bench.py:175
SOLVE_LAM = 3e5       # phase 7: tens of samples carry weight (at the
                      # presets' lam = 1 the softmax is one-hot)
W_TOL = 2e-5          # phase 7: Σwε / u_new absolute, η and raw rows relative
BATCH, BATCH_STEPS = 4096, 50      # BASELINE config 4 at K=128, T=30
BIG_K_STEPS = 50      # phase 4: K=8192 at every cluster size
FLEET_CMP_STEPS = 50  # phase 11: fleet kernel == fused kernel, bitwise
FLEET_STEPS = 2000    # phase 12: the fleet path
CLI_STEPS, CKPT_EVERY = 200, 100   # phase 13
FLEET_TIME_STEPS, PLAIN_FLEET_STEPS = 1000, 3   # phase 14
CONFIG5 = 32768       # phase 22: BASELINE config 5's scenarios
CONFIG5_TIME_STEPS = 512   # phase 22: steps of a timed fleet-kernel launch
CONFIG5_SPREAD = (4096, 8191, 12288, 16383, 20480, 24575, 28672, 32767)
SOAK_STEPS, SOAK_CHUNKS = 40000, 4   # phase 23
# phase 23's path: 10 revolutions of 3600 points each, whose end both
# loops reach near step 33,000 (32,644 and 33,072 on an H100, PERF.md)
SOAK_WAYPOINTS, SOAK_REVOLUTIONS = 36000, 10
PATHGEN_STEPS = 2000  # phase 19
# pathgen_kernel's operations a step, by hand from csrc/pathgen_kernel.cu:
# the PD law 12, M 8, G 8, h and C·dq 11, the torque 10, the plant 17
# (with the reciprocal), the Euler step 8, the EE 7, and 8 cos/sin at one
# each
PATHGEN_OPS = 89
ROOT = os.path.dirname(os.path.abspath(__file__))
PROBE_TIME_CALLS = 100  # phase 15: launches per device-time window
BENCH_TIMEOUT_S = 300    # phase 24


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def compare(label, cuda_sim, arm, cfg, sim, ref, device, seed, eps=None):
    """Kernel vs plain twin for CMP_STEPS steps; returns max |Δq|."""
    import torch

    T = cfg.horizon
    f32 = torch.float32
    args = (arm, cfg, sim, ref,
            torch.tensor([sim.q0], dtype=f32, device=device),
            torch.tensor([sim.dq0], dtype=f32, device=device),
            torch.tensor(cfg.warm_start, dtype=f32,
                         device=device).repeat(1, T, 1).contiguous(),
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.tensor([seed], device=device), CMP_STEPS)
    rec_k, uf_k = cuda_sim.fused_sim_run_batched(*args, eps=eps)
    rec_p, uf_p = cuda_sim.fused_sim_reference(*args, eps=eps)
    torch.cuda.synchronize()
    rk, rp = rec_k[0].cpu().numpy(), rec_p[0].cpu().numpy()
    check(np.isfinite(rk).all(), f"{label}: kernel records not finite")
    dq = np.abs(rk[:, 0:2] - rp[:, 0:2]).max(axis=1)
    du = np.abs(rk[:, 4:6] - rp[:, 4:6]).max(axis=1)
    stats_rel = (np.abs(rk[0, 8:12] - rp[0, 8:12])
                 / np.maximum(np.abs(rp[0, 8:12]), 1e-30))
    print(f"{label}: per-step max|dq| {np.array2string(dq, precision=2)}")
    print(f"{label}: per-step max|du| {np.array2string(du, precision=2)}")
    print(f"{label}: step-0 stats rel err {np.array2string(stats_rel, precision=2)}")
    for i in range(CMP_STEPS):
        check(dq[i] <= Q_TOL * 4 ** i,
              f"{label}: q step {i} off by {dq[i]} > {Q_TOL * 4 ** i}")
        check(du[i] <= U_TOL * 4 ** i,
              f"{label}: u step {i} off by {du[i]} > {U_TOL * 4 ** i}")
    check(np.array_equal(rk[:, 6:8], rp[:, 6:8]),
          f"{label}: wp_idx/done lanes differ")
    check((stats_rel <= STATS_RTOL).all(),
          f"{label}: step-0 stats off by {stats_rel} relative")
    print(f"{label}: kernel == twin within tolerance")
    return float(dq.max())


def fleet_compare(label, cuda_sim, arm, cfg, sim, ref, B, group, device,
                  noise, frozen_mix):
    """The fleet kernel (``group``) against the fused kernel (group=1) over
    FLEET_CMP_STEPS steps, bit for bit and twice, then against the stacked
    plain twin over CMP_STEPS steps in phase 2's bands; returns max |Δq|
    against the twin."""
    import torch

    T, K = cfg.horizon, cfg.num_samples
    rng = np.random.default_rng(B + K)
    q0 = np.array([sim.q0]) + 0.01 * rng.normal(size=(B, 2))
    wp = torch.zeros(B, dtype=torch.int64, device=device)
    if frozen_mix:       # odd scenarios start at the last waypoint: frozen
        wp[1::2] = ref.shape[0] - 1
    args = (arm, cfg, sim, ref,
            torch.as_tensor(q0.astype(np.float32), device=device),
            torch.zeros(B, 2, device=device),
            torch.tensor(cfg.warm_start, dtype=torch.float32,
                         device=device).repeat(B, T, 1).contiguous(),
            wp, torch.arange(B, device=device) + 5)
    kw = dict(step0=torch.arange(B, device=device) * 3)
    eps = None
    if noise == "eps":
        eps = torch.as_tensor(
            (rng.normal(size=(B, FLEET_CMP_STEPS, K, T, 2))
             * np.sqrt(20.0)).astype(np.float32), device=device)
    run = lambda g, n, e: cuda_sim.fused_sim_run_batched(*args, n, eps=e,
                                                          group=g, **kw)
    before = cuda_sim.FLEET_LAUNCHES
    rec1, uf1 = run(1, FLEET_CMP_STEPS, eps)
    recg, ufg = run(group, FLEET_CMP_STEPS, eps)
    again = run(group, FLEET_CMP_STEPS, eps)
    torch.cuda.synchronize()
    check(cuda_sim.FLEET_LAUNCHES == before + 2,
          f"{label}: the fleet kernel was not launched")
    differ = int((recg != rec1).any(dim=2).sum())
    check(torch.equal(recg, rec1) and torch.equal(ufg, uf1),
          f"{label}: fleet kernel != fused kernel ({differ} record rows "
          f"differ)")
    check(torch.equal(again[0], recg) and torch.equal(again[1], ufg),
          f"{label}: two runs differ")
    frozen = int((recg[:, -1, 7] > 0.5).sum())
    if frozen_mix:
        check(frozen == B // 2 and bool((recg[0::2, :, 7] == 0).all()),
              f"{label}: the frozen/active mix did not hold ({frozen})")
    e8 = None if eps is None else eps[:, :CMP_STEPS].contiguous()
    rk, _ = run(group, CMP_STEPS, e8)
    rp, _ = cuda_sim.fused_sim_reference_stacked(*args, CMP_STEPS, eps=e8,
                                                 **kw)
    print(f"{label}: records and u_final == the fused kernel's, bitwise, "
          f"over {FLEET_CMP_STEPS} steps ({frozen} of {B} frozen at the "
          f"end); deterministic")
    return stacked_bands(label, rk, rp)


def stacked_bands(label, rk, rp):
    """(B, CMP_STEPS, 12) fleet-kernel rows against the stacked plain
    twin's, in phase 2's bands over all scenarios; returns max |Δq|."""
    import torch

    torch.cuda.synchronize()
    dq = (rk[..., 0:2] - rp[..., 0:2]).abs().amax(dim=(0, 2)).cpu().numpy()
    du = (rk[..., 4:6] - rp[..., 4:6]).abs().amax(dim=(0, 2)).cpu().numpy()
    stats_rel = ((rk[:, 0, 8:12] - rp[:, 0, 8:12]).abs()
                 / rp[:, 0, 8:12].abs().clamp_min(1e-30)).amax().item()
    for i in range(CMP_STEPS):
        check(dq[i] <= Q_TOL * 4 ** i, f"{label}: q step {i} off by {dq[i]}")
        check(du[i] <= U_TOL * 4 ** i, f"{label}: u step {i} off by {du[i]}")
    check(torch.equal(rk[..., 6:8], rp[..., 6:8]),
          f"{label}: wp_idx/done lanes differ from the stacked twin")
    check(stats_rel <= STATS_RTOL, f"{label}: step-0 stats off by "
          f"{stats_rel} relative")
    print(f"{label}: vs the stacked twin over {rk.shape[0]} scenarios, "
          f"per-step max|dq| {np.array2string(dq, precision=2)}, max|du| "
          f"{np.array2string(du, precision=2)}, step-0 stats rel "
          f"{stats_rel:.2g}")
    return float(dq.max())


def cluster_equal(label, m, cuda_sim, arm, cfg, sim, ref, device, steps,
                  eps=None):
    """``fused_sim_run`` at every cluster size that fits K against
    ``cluster=1``: records and u_final bit for bit.  Returns the cluster-1
    (records, u_final)."""
    import torch

    st0 = m.init_sim(cfg, sim, seed=0, device=device)
    args = (arm, cfg, sim, ref, st0.q, st0.dq, st0.mppi.u_prev,
            st0.mppi.wp_idx, st0.seed, steps)
    nwarp = cuda_sim.sim_threads(cfg.num_samples) // 32
    sizes = sorted(c for c in cuda_sim.CLUSTER_SIZES if nwarp % c == 0)
    rec1, uf1 = cuda_sim.fused_sim_run(*args, eps=eps, cluster=1)
    for c in sizes[1:]:
        rec, uf = cuda_sim.fused_sim_run(*args, eps=eps, cluster=c)
        torch.cuda.synchronize()
        differ = int((rec != rec1).any(dim=1).sum())
        check(torch.equal(rec, rec1) and torch.equal(uf, uf1),
              f"{label}: cluster {c} != cluster 1 ({differ} record rows "
              f"differ)")
    check(bool(torch.isfinite(rec1).all()), f"{label}: records not finite")
    print(f"{label}: records and u_final at cluster sizes {sizes} == "
          f"cluster 1, bitwise, over {steps} steps")
    return rec1, uf1


def onpath_by_scenario_mm(rec, path_xy):
    """Each scenario's mean distance to the nearest path point over its
    live steps, mm, on the device (a (steps, B) record)."""
    import torch

    p = torch.as_tensor(path_xy, device=rec.ee.device)
    total = torch.zeros(rec.ee.shape[1], dtype=torch.float64,
                        device=p.device)
    rows = max(1, 102400 // rec.ee.shape[1])   # 25 steps at 4096 scenarios
    for i in range(0, rec.ee.shape[0], rows):
        ee = rec.ee[i:i + rows]
        d = torch.cdist(ee.reshape(-1, 2), p).amin(dim=1).view(ee.shape[:2])
        total += torch.where(rec.done[i:i + rows], 0.0,
                             d).double().sum(dim=0)
    live = (~rec.done).sum(dim=0).clamp_min(1)
    return (total / live * 1e3).cpu().numpy()


def compare_records(label, a, b):
    """Two SimRecords over their first CMP_STEPS steps, in phase 2's bands
    (the stats lanes at step 0 within STATS_RTOL)."""
    q = (a.q[:CMP_STEPS] - b.q[:CMP_STEPS]).abs().amax(dim=1).cpu().numpy()
    u = (a.u[:CMP_STEPS] - b.u[:CMP_STEPS]).abs().amax(dim=1).cpu().numpy()
    print(f"{label}: per-step max|dq| {np.array2string(q, precision=2)}")
    print(f"{label}: per-step max|du| {np.array2string(u, precision=2)}")
    for i in range(CMP_STEPS):
        check(q[i] <= Q_TOL * 4 ** i, f"{label}: q step {i} off by {q[i]}")
        check(u[i] <= U_TOL * 4 ** i, f"{label}: u step {i} off by {u[i]}")
    for f in ("wp_idx", "done"):
        check(bool((getattr(a, f)[:CMP_STEPS]
                    == getattr(b, f)[:CMP_STEPS]).all()),
              f"{label}: {f} differs")
    for f in ("cost_min", "cost_mean", "ess", "weight_entropy"):
        x, y = float(getattr(a, f)[0]), float(getattr(b, f)[0])
        check(abs(x - y) <= STATS_RTOL * max(abs(y), 1e-30),
              f"{label}: step-0 {f} {x} vs {y}")
    print(f"{label}: within the bands for {CMP_STEPS} steps")


def step_compare(label, loop, cuda_step, solve_kernels, arm, cfg, sim, ref,
                 states, steps=CMP_STEPS):
    """Phase 20: ``steps`` steps of the per-step loop's chunk (the step
    head, then each step the solve kernel and the step tail, which carries
    the next step's head) with the step kernels and with their plain
    versions, on the same card tensors; everything bit for bit but the
    mean cost, ESS and entropy, which must agree within STEP_STATS_RTOL
    relative, the entropy relative to the larger of itself and its range
    log K (a softmax on one sample has an entropy near 0, where one
    rounding of a weight near 1 is a large share), and must equal
    ``cuda_step.tail_stats_ordered`` of the step's costs bit for bit
    (zeroed where done).  The plain head also runs on the state the head
    kernel starts from and on the state after every step of the kernels'
    run: the head kernel's four outputs (x0, the new index, the path end,
    the window), and at every step the head the tail kernel carries, must
    equal its.  Returns the largest absolute error of the heads' outputs
    and of those three statistics."""
    import torch

    head_err = 0.0

    def same_head(h, st, what):
        nonlocal head_err
        p = cuda_step.step_head_plain(cfg, ref, st.q, st.dq, st.mppi.wp_idx)
        d = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(h, p))
        head_err = max(head_err, d)
        check(all(torch.equal(a, b) for a, b in zip(h, p)),
              f"{label}: {what}: x0, index, path end or window differs "
              f"from the plain head's (max |d| {d:.3g})")

    def run(head, tail):
        kernels = tail is cuda_step.step_tail
        st, clock = states, states.step.clone()
        rows = loop._row_buffers(steps, st, ref)
        h = head(cfg, ref, st.q, st.dq, st.mppi.wp_idx)
        if kernels:
            same_head(h, st, "the step head kernel")
        for i in range(steps):
            x0, wp, path_end, window = h
            u_seq, s, _ = solve_kernels(arm, cfg, x0, st.mppi.u_prev, window,
                                        st.seed, None, st.step, False)
            *nxt, clock, h = tail(arm, cfg, sim, ref,
                                  *loop._state_tensors(st)[:5], st.done, wp,
                                  path_end, u_seq, s, clock,
                                  tuple(r[i] for r in rows), carry_head=True)
            st = loop._as_state((*nxt[:5], st.seed, nxt[5]))
            if kernels:
                same_head(h, st, f"step {i}: the head the step tail kernel "
                          f"carries")
                twin = cuda_step.tail_stats_ordered(s, cfg.lam)
                for name, got, want in zip(
                        ("cost_min", "cost_mean", "ess", "weight_entropy"),
                        (rows[7][i], rows[8][i], rows[9][i], rows[10][i]),
                        twin):
                    want = torch.where(st.done, torch.zeros_like(want), want)
                    check(torch.equal(got, want),
                          f"{label}: step {i}: {name} differs from its "
                          f"order in torch (tail_stats_ordered)")
        return st, rows

    kern = run(cuda_step.step_head, cuda_step.step_tail)
    plain = run(cuda_step.step_head_plain, cuda_step.step_tail_plain)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(
        loop._state_tensors(kern[0]), loop._state_tensors(plain[0]))),
        f"{label}: the step kernels' final state differs from the plain "
        f"versions'")
    err, rel = 0.0, 0.0
    for name, a, b in zip(("q", "dq", "u", "ee", "elbow", "ref_xy", "wp_idx",
                           "cost_min", "cost_mean", "ess", "weight_entropy",
                           "done"), kern[1], plain[1]):
        if name in ("cost_mean", "ess", "weight_entropy"):
            d = (a - b).abs()
            floor = (math.log(cfg.num_samples) if name == "weight_entropy"
                     else 1e-30)
            r = float((d / b.abs().clamp_min(floor)).max())
            check(r <= STEP_STATS_RTOL,
                  f"{label}: {name} off by {r:.3g} relative")
            err, rel = max(err, float(d.max())), max(rel, r)
        else:
            check(torch.equal(a, b), f"{label}: record {name} differs from "
                  f"the plain versions'")
    B = states.q.shape[0]
    from mppi_robotarm_tpu_torch.ops.cuda_solve import _sm_count

    layout = cuda_step.step_tail_layout(cfg.num_samples, B,
                                        _sm_count(states.q.device))
    print(f"{label}: the step kernels == their plain versions over {steps} "
          f"steps of {B} scenario(s) (K={cfg.num_samples}; the tail's "
          f"layout {layout}): the head kernel's x0, index, path end and "
          f"window, and the head the tail carries at every step (max |d| "
          f"{head_err:.3g}), state, q, dq, "
          f"u, ee, elbow, ref_xy, wp_idx, cost_min, done bitwise; cost_mean, "
          f"ess, entropy within {rel:.3g} relative (the entropy's to at "
          f"least log K; max |d| {err:.3g}; band {STEP_STATS_RTOL}) and "
          f"== tail_stats_ordered bitwise; "
          f"{int(kern[1][-1][-1].sum())} scenario(s) "
          f"done at the end")
    return head_err, err


def shard_step_compare(label, sharded, cuda_solve, arm, cfg, sim, ref,
                       state, noise, rng, steps=CMP_STEPS):
    """Phase 21: ``steps`` sample-sharded steps of B scenarios in one
    process, the two shards stacked as phase 16 stacks them: the step
    head, the solve kernel on each shard (k_offset, normalize=False),
    MIN, the rescale, SUM, the finish and the step tail (no row, done all
    false), once with the step kernels (``sharded._kernels``) and once
    with their plain versions (``sharded._plain_versions``) on the same
    card tensors.  Every output of every step (the head's four, the
    summed message, u_seq, and the tail's q, dq, u_prev, index) must be
    bit for bit the plain versions', one launch of each kernel a step.
    Returns the largest absolute difference of the message and u_seq."""
    import torch

    from mppi_robotarm_tpu_torch.ops import cuda_shard, cuda_step

    B, T, K = state[0].shape[0], cfg.horizon, cfg.num_samples
    kl, device = K // 2, ref.device
    tail_cfg = dataclasses.replace(cfg, num_samples=kl)
    stacked = lambda x, op: (x.amin(0, keepdim=True) if op == "min"
                             else x.sum(0, keepdim=True)).expand_as(x)
    eps = (torch.as_tensor((rng.normal(size=(steps, B, K, T, 2)) * np.sqrt(
        20.0)).astype(np.float32), device=device) if noise == "eps"
        else None)
    seeds = torch.arange(B, device=device) + 3
    zero = torch.zeros(B, dtype=torch.int64, device=device)
    not_done = torch.zeros(B, dtype=torch.bool, device=device)

    def run(ops):
        head, scale, finish, tail = ops
        q, dq, u, wp = state
        rows = []
        for i in range(steps):
            x0, wp_new, end, window = head(cfg, ref, q, dq, wp)
            parts = [cuda_solve.solve_batched(
                arm, cfg, x0, u, window, emit_eps=False, normalize=False,
                k_local=kl, k_offset=torch.full((B,), r * kl, device=device),
                **(dict(eps=eps[i][:, r * kl:(r + 1) * kl].contiguous())
                   if noise == "eps" else
                   dict(seed=seeds, step=torch.full((B,), i, device=device))))
                for r in range(2)]
            _, packed = sharded._combine(
                torch.stack([p[3][0] for p in parts]),
                torch.stack([p[3][1] for p in parts]),
                torch.stack([p[0] for p in parts]), cfg.lam, stacked, scale)
            u_seq = finish(cfg, packed[0], u)
            _, q, dq, u, wp, _, _ = tail(arm, tail_cfg, sim, ref, zero, q, dq,
                                         u, wp, not_done, wp_new, end, u_seq,
                                         parts[0][1])
            rows.append((x0, wp_new, end, window, packed[0], u_seq, q, dq, u,
                         wp))
        return rows

    counts = lambda: (cuda_step.HEAD_LAUNCHES, cuda_shard.SCALE_LAUNCHES,
                      cuda_shard.FINISH_LAUNCHES, cuda_step.TAIL_LAUNCHES)
    before = counts()
    kern = run(sharded._kernels())
    torch.cuda.synchronize()
    made = [b - a for a, b in zip(before, counts())]
    plain = run(sharded._plain_versions())
    torch.cuda.synchronize()
    check(made == [steps] * 4, f"{label}: head, scale, finish and tail "
          f"launches {made}, expected {steps} each")
    err = 0.0
    names = ("x0", "index", "path_end", "window", "message", "u_seq", "q",
             "dq", "u_prev", "index after")
    for i, (a, b) in enumerate(zip(kern, plain)):
        for name, x, y in zip(names, a, b):
            if name in ("message", "u_seq"):
                err = max(err, float((x - y).abs().max()))
            check(torch.equal(x, y), f"{label}: step {i}: {name} differs "
                  f"from the plain versions'")
    frozen = int(kern[-1][2].sum())
    print(f"{label}: {steps} sharded steps (2 shards of K_local {kl}, "
          f"stacked), the step kernels == their plain versions bitwise: the "
          f"head, the summed message, u_seq, q, dq, u_prev and index; one "
          f"head, scale, finish and tail launch a step; {frozen} of {B} "
          f"scenario(s) at the path end at the last step")
    return err


def bits(x):
    """A tensor's or array's bits, floats viewed as integers of their width,
    so that equality of two is bit for bit, a NaN's included."""
    import torch

    if isinstance(x, torch.Tensor):
        if not x.is_floating_point():
            return x
        return x.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    x = np.asarray(x)
    return x.view(f"i{x.itemsize}") if x.dtype.kind == "f" else x


def same_bits(a, b):
    """Two tensors (or arrays) equal bit for bit, NaNs included."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(bits(np.asarray(a)), bits(np.asarray(b)))
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (bits(a) == bits(b)).all())


def peak_memory(torch, device):
    """Reset the device's peak-memory count; returns a function that gives
    the peak since then above what was allocated at the reset, bytes."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return lambda: torch.cuda.max_memory_allocated(device) - base


def solve_compare(label, cuda_solve, philox_epsilon, arm, cfg, ref, B,
                  device, rng, noise, **kw):
    """Solve kernels vs their plain twin on one call; returns
    (max |ΔS|, max |Δ Σwε or u_new|)."""
    import torch

    T, K = cfg.horizon, kw.get("k_local") or cfg.num_samples
    x0 = torch.as_tensor((np.array([1.1522, -1.2661, 0.1, -0.2])
                          + rng.normal(scale=0.01, size=(B, 4))
                          ).astype(np.float32), device=device)
    u = torch.as_tensor((np.array([10.0, -2.0]) + rng.normal(size=(B, T, 2))
                         ).astype(np.float32), device=device)
    starts = 7 * torch.arange(B, device=device) % (
        ref.shape[0] - cfg.search_idx_len)
    idx = starts[:, None] + torch.arange(cfg.search_idx_len, device=device)
    win = ref[idx].contiguous()
    seeds = [int(v) for v in rng.integers(0, 2 ** 31 - 1, size=B)]
    steps = [int(v) for v in rng.integers(0, 4000, size=B)]
    if noise == "eps":
        kw["eps"] = torch.as_tensor(
            (rng.normal(size=(B, K, T, 2)) * np.sqrt(20.0)).astype(
                np.float32), device=device)
    else:
        kw.update(seed=torch.tensor(seeds, device=device),
                  step=torch.tensor(steps, device=device))
    got = cuda_solve.solve_batched(arm, cfg, x0, u, win, **kw)
    again = cuda_solve.solve_batched(arm, cfg, x0, u, win, **kw)
    want = cuda_solve.solve_batched_reference(arm, cfg, x0, u, win, **kw)
    torch.cuda.synchronize()
    (w_k, s_k, e_k, (m_k, eta_k)), (w_p, s_p, e_p, (m_p, eta_p)) = got, want
    check(bool(torch.isfinite(w_k).all()) and bool(torch.isfinite(s_k).all()),
          f"{label}: kernel output not finite")
    check(torch.equal(s_k, s_p), f"{label}: S differs from the twin")
    check(torch.equal(m_k, m_p), f"{label}: m differs from the twin")
    dw = float((w_k - w_p).abs().max())
    scale = 1.0 if kw.get("normalize", True) else float(w_p.abs().max())
    check(dw <= W_TOL * scale, f"{label}: Σwε off by {dw} (> {W_TOL * scale})")
    deta = float(((eta_k - eta_p).abs() / eta_p).max())
    check(deta <= W_TOL, f"{label}: η off by {deta} relative")
    for a, b in zip((w_k, s_k, m_k, eta_k), (again[0], again[1], *again[3])):
        check(torch.equal(a, b), f"{label}: two runs differ")
    if noise == "prng":
        check(torch.equal(e_k, e_p), f"{label}: noise differs from the twin")
        off = kw.get("k_offset")
        for b in range(0, B, max(1, B // 8)):
            full = philox_epsilon(seeds[b], steps[b], cfg, device)
            o = 0 if off is None else int(off[b])
            check(torch.equal(e_k[b], full[o:o + K]),
                  f"{label}: scenario {b} noise != philox_epsilon")
    print(f"{label}: S, m bitwise; max|dw| {dw:.3g}; max rel deta "
          f"{deta:.3g}; deterministic"
          + ("; eps == twin's bitwise, == philox_epsilon bitwise for "
             f"{len(range(0, B, max(1, B // 8)))} scenarios"
             if noise == "prng" else ""))
    return float((s_k - s_p).abs().max()), dw


def shard_compare(label, cuda_solve, sharded, arm, cfg, ref, B, S, device,
                  rng, noise):
    """Phase 16: K split into S launches of the solve kernel (k_offset,
    normalize=False), combined by ``sharded.combine_partials`` over the
    stacked shards, against one unsharded launch on the same inputs: S and
    m bit for bit, Σwε and u_new within W_TOL, η within W_TOL relative.
    Returns (max |Δ Σwε|, max |Δ u_new|)."""
    import torch

    from mppi_robotarm_tpu_torch.mppi.solver import _median_update

    T, K = cfg.horizon, cfg.num_samples
    x0 = torch.as_tensor((np.array([1.1522, -1.2661, 0.1, -0.2])
                          + rng.normal(scale=0.01, size=(B, 4))
                          ).astype(np.float32), device=device)
    u = torch.as_tensor((np.array([10.0, -2.0]) + rng.normal(size=(B, T, 2))
                         ).astype(np.float32), device=device)
    starts = 11 * torch.arange(B, device=device) % (
        ref.shape[0] - cfg.search_idx_len)
    win = ref[starts[:, None] + torch.arange(cfg.search_idx_len,
                                             device=device)].contiguous()
    if noise == "eps":
        eps = torch.as_tensor((rng.normal(size=(B, K, T, 2)) * np.sqrt(
            20.0)).astype(np.float32), device=device)
        noise_kw = lambda r0, r1: dict(eps=eps[:, r0:r1].contiguous())
    else:
        seed = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, size=B),
                               device=device)
        step = torch.as_tensor(rng.integers(0, 4000, size=B), device=device)
        noise_kw = lambda r0, r1: dict(seed=seed, step=step)
    w1, s1, _, (m1, eta1) = cuda_solve.solve_batched(
        arm, cfg, x0, u, win, emit_eps=False, **noise_kw(0, K))
    u1 = cuda_solve.solve_batched(arm, cfg, x0, u, win, emit_eps=False,
                                  fuse_update=True, **noise_kw(0, K))[0]
    kl = K // S
    parts = [cuda_solve.solve_batched(
        arm, cfg, x0, u, win, emit_eps=False, normalize=False, k_local=kl,
        k_offset=torch.full((B,), r * kl, device=device),
        **noise_kw(r * kl, (r + 1) * kl)) for r in range(S)]
    stacked = lambda x, op: (x.amin(0, keepdim=True) if op == "min"
                             else x.sum(0, keepdim=True)).expand_as(x)
    m, eta, a = sharded.combine_partials(
        torch.stack([p[3][0] for p in parts]),
        torch.stack([p[3][1] for p in parts]),
        torch.stack([p[0] for p in parts]), cfg.lam, stacked)
    w_eps = a[0] / eta[0][:, None, None]
    u_new = _median_update(u, w_eps, cfg)
    torch.cuda.synchronize()
    check(torch.equal(torch.cat([p[1] for p in parts], 1), s1),
          f"{label}: shard S differs from the unsharded solve's")
    check(torch.equal(m[0], m1), f"{label}: combined m differs")
    dw = float((w_eps - w1).abs().max())
    du = float((u_new - u1).abs().max())
    deta = float(((eta[0] - eta1).abs() / eta1).max())
    check(dw <= W_TOL and du <= W_TOL and deta <= W_TOL,
          f"{label}: Σwε off by {dw}, u_new by {du}, η by {deta} relative")
    tiles = {cuda_solve.solve_tile(cfg, k) for k in (K, kl)}
    print(f"{label}: S and m bitwise; max|dΣwε| {dw:.3g}, max|du_new| "
          f"{du:.3g}, max rel dη {deta:.3g} (tiles {sorted(tiles)})")
    return dw, du


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    import mppi_robotarm_tpu_torch as m
    from mppi_robotarm_tpu_torch.mppi.solver import _solve_kernels
    from mppi_robotarm_tpu_torch.ops import (_build, cuda_sim, cuda_solve,
                                             cuda_step)
    from mppi_robotarm_tpu_torch.ops.cuda_rollout import philox_epsilon
    from mppi_robotarm_tpu_torch.sim import loop
    from mppi_robotarm_tpu_torch.tools import fused_timing, overhead, sass_loops
    from mppi_robotarm_tpu_torch.utils.roofline import (UNFUSED_OPS, bound,
                                                        rollout_ops,
                                                        solve_ops)

    check("jax" not in sys.modules, "the port imported JAX")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = overhead.card()
    card = smi.splitlines()[0]
    print(f"device: {name} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(log.strip() or "build: library current, nothing compiled")

    arm, cfg, sim = m.benchmark_preset()
    path_np = m.synth_circle_path(8000)
    ref = torch.as_tensor(path_np, device=device)
    arm_r, cfg_r, sim_r = m.circle_tracking_preset()
    rng = np.random.default_rng(0)

    def noise(c):
        e = rng.normal(size=(1, CMP_STEPS, c.num_samples, c.horizon, 2))
        return torch.as_tensor((e * np.sqrt(20.0)).astype(np.float32),
                               device=device)

    # ---- 2. eps mode ---------------------------------------------------
    max_err = compare("eps benchmark_preset", cuda_sim, arm, cfg, sim, ref,
                      device, 0, noise(cfg))
    compare("eps K=100 T=30", cuda_sim, arm_r, cfg_r, sim_r, ref, device, 0,
            noise(cfg_r))
    # ---- 3. PRNG mode --------------------------------------------------
    compare("prng benchmark_preset", cuda_sim, arm, cfg, sim, ref, device, 0)
    compare("prng K=100 T=30", cuda_sim, arm_r, cfg_r, sim_r, ref, device, 7)

    # ---- 4. the main path ----------------------------------------------
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    chosen = cuda_sim.cluster_size(1, cfg.num_samples, sm_count)
    check(chosen > 1, f"benchmark_preset at B=1 chose cluster {chosen}")
    state0 = m.init_sim(cfg, sim, seed=0, device=device)
    cuda_sim.LAUNCHES = 0
    final, rec = m.simulate_fused(arm, cfg, sim, ref, state0, STEPS)
    torch.cuda.synchronize()
    launches = cuda_sim.LAUNCHES
    check(launches >= 1, "the main path launched no kernel")
    print(f"main path: simulate_fused {STEPS} steps, sim_kernel launches "
          f"{launches}, each a cluster of {chosen} blocks ({sm_count} SMs)")
    rows1, ufin1 = cluster_equal("clusters prng benchmark_preset", m,
                                 cuda_sim, arm, cfg, sim, ref, device, STEPS)
    for field, lanes in (("q", slice(0, 2)), ("dq", slice(2, 4)),
                         ("u", slice(4, 6)), ("cost_min", 8),
                         ("cost_mean", 9), ("ess", 10),
                         ("weight_entropy", 11)):
        check(torch.equal(getattr(rec, field), rows1[:, lanes]),
              f"main path record {field} != fused_sim_run(cluster=1)'s")
    check(torch.equal(rec.wp_idx, rows1[:, 6].long())
          and torch.equal(rec.done, rows1[:, 7] > 0.5)
          and torch.equal(final.mppi.u_prev, ufin1),
          "main path wp_idx/done/u_final != fused_sim_run(cluster=1)'s")
    print(f"main path: records and u_final (cluster {chosen}) == "
          f"fused_sim_run(cluster=1), bitwise")
    cluster_equal("clusters eps benchmark_preset", m, cuda_sim, arm, cfg, sim,
                  ref, device, CMP_STEPS, eps=noise(cfg)[0])
    cluster_equal("clusters eps K=100 T=30", m, cuda_sim, arm_r, cfg_r, sim_r,
                  ref, device, CMP_STEPS, eps=noise(cfg_r)[0])
    cluster_equal("clusters prng K=8192 H=50", m, cuda_sim, arm,
                  dataclasses.replace(cfg, num_samples=8192), sim, ref,
                  device, BIG_K_STEPS)
    for field, v in zip(rec._fields, rec):
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"record {field} not finite")
    check(tuple(rec.q.shape) == (STEPS, 2), f"record shape {rec.q.shape}")
    path_xy = path_np[:, 0:2]

    def live_onpath(r):
        mean, n = fused_timing.live_onpath_mm(r, path_xy)
        check(n >= 1000, f"only {n} live steps")
        return mean, n

    onpath, n_live = live_onpath(rec)
    print(f"main path: on-path mean {onpath:.3f} mm over {n_live} live "
          f"steps (gate {ONPATH_GATE_MM} mm), final wp "
          f"{int(final.mppi.wp_idx)}, final step {int(final.step)}")
    check(onpath < ONPATH_GATE_MM, f"on-path mean {onpath:.3f} mm")
    arm_h, cfg_h, sim_h = m.high_accuracy_preset()
    _, rec_h = m.simulate_fused(arm_h, cfg_h, sim_h, ref,
                                m.init_sim(cfg_h, sim_h, seed=0,
                                           device=device), STEPS)
    ha, n_live_h = live_onpath(rec_h)
    print(f"high_accuracy_preset: on-path mean {ha:.3f} mm over {n_live_h} "
          f"live steps (gate {HA_GATE_MM} mm)")
    check(ha < HA_GATE_MM, f"high-accuracy on-path mean {ha:.3f} mm")

    # ---- 5. continuation -----------------------------------------------
    s1, r1 = m.simulate_fused(arm, cfg, sim, ref, state0, STEPS // 2)
    s2, r2 = m.simulate_fused(arm, cfg, sim, ref, s1, STEPS - STEPS // 2)
    for field, a, b1, b2 in zip(rec._fields, rec, r1, r2):
        check(torch.equal(a, torch.cat([b1, b2])),
              f"chained record {field} differs from one launch")
    check(torch.equal(s2.mppi.u_prev, final.mppi.u_prev)
          and torch.equal(s2.q, final.q) and int(s2.step) == int(final.step),
          "chained final state differs from one launch")
    print(f"continuation: {STEPS // 2} + {STEPS - STEPS // 2} chained steps "
          f"== one {STEPS}-step launch, bitwise")

    # ---- 6. timing -----------------------------------------------------
    def cuda_time(fn, reps):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return times

    k1_rows = fused_timing.measure(device, STEPS)
    for row in k1_rows:
        print(f"timing [{card}]: sim_kernel {row['setting']} "
              f"{row['us_per_step']:.2f} us/step over a {STEPS}-step launch, "
              f"runs {[round(t, 2) for t in row['runs_ms']]} ms; records and "
              f"u_final sha256 {row['sha256']}")
    check(len({row["sha256"] for row in k1_rows}) == 1,
          "the cluster sizes' 4000-step runs differ")
    check({row["sha256"] for row in k1_rows}
          == {fused_timing.digest(rows1, ufin1)},
          "the timing runs' records differ from phase 4's")
    kern_ms = next(row["us_per_step"] for row in k1_rows
                   if row["setting"] == f"cluster={chosen}") / 1e3
    plain_steps = 20
    plain = cuda_time(lambda: cuda_sim.fused_sim_reference(
        arm, cfg, sim, ref, state0.q[None], state0.dq[None],
        state0.mppi.u_prev[None], state0.mppi.wp_idx.reshape(1),
        torch.tensor([0]), plain_steps), 2)
    plain_ms = min(plain) / plain_steps
    print(f"timing [{card}]: sim_kernel on the main path's cluster of "
          f"{chosen}: {kern_ms * 1e3:.2f} us/step ({1e3 / kern_ms:,.0f} "
          f"solves/s)")
    print(f"timing [{card}]: plain twin {plain_ms * 1e3:.1f} us/step over "
          f"{plain_steps} steps, runs {[round(t, 2) for t in plain]} ms")

    # ---- 7. the solve kernels against their plain twin -----------------
    cfg_w = dataclasses.replace(cfg, lam=SOLVE_LAM)
    cfg_r = dataclasses.replace(cfg_r, lam=SOLVE_LAM)
    cfg_l = dataclasses.replace(cfg_w, num_samples=65536)
    cfg_f = dataclasses.replace(cfg_w, num_samples=128, horizon=30)
    s_err, w_err = 0.0, 0.0
    for noise in ("eps", "prng"):
        for label, c, B, fuse in (("K=1024 H=50", cfg_w, 1, True),
                                  ("K=1024 H=50", cfg_w, 64, True),
                                  ("K=100 T=30", cfg_r, 8, False),
                                  ("K=65536 H=50", cfg_l, 1, True),
                                  ("K=128 T=30", cfg_f, BATCH, True)):
            # the last is phase 9's solve: one tile per scenario, fused
            ds, dw = solve_compare(f"solve {noise} {label} B={B}", cuda_solve,
                                   philox_epsilon, arm, c, ref, B, device,
                                   rng, noise, fuse_update=fuse)
            s_err, w_err = max(s_err, ds), max(w_err, dw)
    cfg_k = dataclasses.replace(cfg_w, num_samples=4096, exploration=0.5)
    ds, _ = solve_compare("solve prng raw rows k_offset", cuda_solve,
                          philox_epsilon, arm, cfg_k, ref, 2, device, rng,
                          "prng", normalize=False, k_local=1500,
                          k_offset=[0, 1700])
    s_err = max(s_err, ds)

    # ---- 8. the per-step path ------------------------------------------
    graph_steps = loop._GRAPH_STEPS
    loop._GRAPHS.clear()
    cuda_solve.LAUNCHES = cuda_solve.COMBINE_LAUNCHES = 0
    cuda_step.HEAD_LAUNCHES = cuda_step.TAIL_LAUNCHES = 0
    cuda_step.CARRIED_HEADS = 0
    t0 = time.perf_counter()
    final_p, rec_p = m.simulate(arm, cfg, sim, ref, state0, STEPS,
                                backend="cuda")
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    solve_launches = cuda_solve.LAUNCHES
    combine_launches = cuda_solve.COMBINE_LAUNCHES
    head_launches = cuda_step.HEAD_LAUNCHES
    tail_launches = cuda_step.TAIL_LAUNCHES
    carried_heads = cuda_step.CARRIED_HEADS
    chunks = -(-STEPS // graph_steps)
    captures = {g.n: g.capture_s for g in loop._GRAPHS.values()}
    live = int((~rec_p.done).sum())
    print(f"per-step path: simulate(backend='cuda') {STEPS} steps as "
          f"replayed CUDA graphs of {graph_steps} steps (captured: "
          + ", ".join(f"{n} steps in {t:.3f} s" for n, t in
                      sorted(captures.items()))
          + f"), solve_tile_kernel launches {solve_launches}, "
          f"step_head_kernel {head_launches}, step_tail_kernel "
          f"{tail_launches} ({carried_heads} carrying the next step's "
          f"head), separate combine launches {combine_launches}, "
          f"live steps {live}, "
          f"{loop_wall:.3f} s wall with the captures")
    check(captures and len(captures) <= 2 and max(captures) == graph_steps,
          f"the per-step path captured {sorted(captures)}, not chunks of "
          f"{graph_steps} steps")
    final_e, rec_e = loop._step_loop(arm, cfg, sim, ref,
                                     loop._as_batch(state0), STEPS,
                                     graphs=False)
    for field, a, b in zip(rec_p._fields, rec_p, rec_e):
        check(torch.equal(a, b[:, 0]),
              f"per-step record {field}: graphs != the eager chunked loop")
    check(all(torch.equal(a, b[0]) for a, b in zip(
        (final_p.step, final_p.q, final_p.dq, *final_p.mppi, final_p.done),
        (final_e.step, final_e.q, final_e.dq, *final_e.mppi, final_e.done))),
        "per-step final state: graphs != the eager chunked loop")
    print(f"per-step path: records and final state == the eager chunked "
          f"loop's, bitwise, over {STEPS} steps")
    check(solve_launches == STEPS >= live,
          f"the per-step path made {solve_launches} solve launches in "
          f"{STEPS} steps, not one a step")
    check(combine_launches == 0,
          f"the per-step path made {combine_launches} combine launches")
    check((head_launches, tail_launches, carried_heads)
          == (chunks, STEPS, STEPS - chunks),
          f"the per-step path made {head_launches} step head and "
          f"{tail_launches} step tail launches, {carried_heads} of them "
          f"carrying the head, in {STEPS} steps, not a head a chunk of "
          f"{graph_steps} ({chunks}) and a tail a step, all but each "
          f"chunk's last carrying the head")
    for field, v in zip(rec_p._fields, rec_p):
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"per-step {field} not finite")
    onpath_p, n_live_p = live_onpath(rec_p)
    print(f"per-step path: on-path mean {onpath_p:.3f} mm over {n_live_p} "
          f"live steps (gate {ONPATH_GATE_MM} mm), final wp "
          f"{int(final_p.mppi.wp_idx)}")
    check(onpath_p < ONPATH_GATE_MM, f"per-step on-path mean {onpath_p:.3f}")
    compare_records("per-step vs fused", rec_p, rec)

    # ---- 9. the batch --------------------------------------------------
    cfg_b = dataclasses.replace(cfg, num_samples=128, horizon=30)
    ref_b = torch.as_tensor(m.synth_circle_path(2000), device=device)
    q0_b = (np.array([[1.1522, -1.2661]])
            + 0.01 * np.random.default_rng(9).normal(size=(BATCH, 2)))
    states_b = m.init_sim_batch(cfg_b, sim, np.arange(BATCH),
                                q0=q0_b.astype(np.float32), device=device)
    run_batch = lambda: m.simulate_batch(arm, cfg_b, sim, ref_b, states_b,
                                         BATCH_STEPS, backend="cuda")
    peak_of = peak_memory(torch, device)
    final_b, rec_b = run_batch()
    peak_b = peak_of()
    for field, v in zip(rec_b._fields, rec_b):
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"batch {field} not finite")
    one = m.init_sim(cfg_b, sim, seed=0, device=device)._replace(
        q=states_b.q[0])
    _, rec_1 = m.simulate(arm, cfg_b, sim, ref_b, one, BATCH_STEPS,
                          backend="cuda")
    for field, a, b in zip(rec_b._fields, rec_b, rec_1):
        check(torch.equal(a[:, 0], b),
              f"batch scenario 0 {field} differs from its run alone")
    print(f"batch: {BATCH} scenarios x {BATCH_STEPS} steps (K=128, T=30) "
          f"finite; scenario 0 == its run alone, bitwise; "
          f"{int((~rec_b.done[-1]).sum())} scenarios live at the end; peak "
          f"device memory {peak_b / 1e9:.3f} GB above what was allocated "
          f"before (graph captures included)")

    # ---- 10. timing ----------------------------------------------------
    x1 = torch.cat([state0.q, state0.dq])[None]
    u1 = state0.mppi.u_prev[None].contiguous()
    win1 = ref[:cfg.search_idx_len][None].contiguous()
    timing = {}
    cfg_fs = dataclasses.replace(cfg, num_samples=128, horizon=30)
    for label, c, B in (("K=1024 H=50", cfg, 1),
                        ("K=65536 H=50",
                         dataclasses.replace(cfg, num_samples=65536), 1),
                        (f"fleet {BATCH} x K=128 T=30", cfg_fs, BATCH)):
        # phase 9's per-step solve: its states, controls and windows
        xs = (x1 if B == 1 else torch.cat([states_b.q, states_b.dq], 1))
        us = (u1 if B == 1 else states_b.mppi.u_prev.contiguous())
        ws = (win1 if B == 1 else ref_b[
            states_b.mppi.wp_idx[:, None]
            + torch.arange(c.search_idx_len, device=device)].contiguous())
        kw = dict(seed=torch.arange(B, device=device),
                  step=torch.zeros(B, dtype=torch.int64, device=device),
                  fuse_update=True, emit_eps=False)
        call = lambda: cuda_solve.solve_batched(arm, c, xs, us, ws, **kw)
        dev_us = fused_timing.solve_device_us(call)
        check(set(dev_us) == {"solve_tile_kernel"},
              f"solve {label}: the profiler saw {sorted(dev_us)}, not one "
              f"solve_tile_kernel launch a call")
        ev = [t / 20 for t in cuda_time(lambda: [call() for _ in range(20)], 3)]
        plain = cuda_time(lambda: cuda_solve.solve_batched_reference(
            arm, c, xs, us, ws, **kw), 3)
        K = c.num_samples
        tile, n_tiles, lanes, group = cuda_solve._plan(
            c, K, None, True, True, B, sm_count)
        timing[label] = (dev_us, min(ev), min(plain))
        print(f"timing [{card}]: solve {label} B={B}: solve_tile_kernel, "
              f"one launch: {dev_us['solve_tile_kernel']:.2f} us device time "
              f"(layout chosen for {sm_count} SMs: {lanes} lanes a sample, "
              f"tile {tile}, {n_tiles} tiles a scenario, {group} a block); "
              f"{min(ev) * 1e3:.2f} us "
              f"per call by CUDA events over 20 calls, runs "
              f"{[round(t * 1e3, 2) for t in ev]}; plain twin "
              f"{min(plain) * 1e3:.1f} us/solve")

    loop_steps, steps_w = 1000, 300
    one0 = loop._as_batch(state0)
    # the graphs through the public entry; the eager loop is reached only
    # through the private loop, on the state made a batch of one beforehand
    loops = {"graphs": lambda n: m.simulate(arm, cfg, sim, ref, state0, n,
                                            backend="cuda"),
             "eager": lambda n: loop._step_loop(arm, cfg, sim, ref, one0, n,
                                                graphs=False)}
    for n in (loop_steps, steps_w):     # capture the graphs before timing
        loops["graphs"](n)
    lt = {k: [] for k in loops}
    for _ in range(3):
        for k, run in loops.items():
            lt[k] += cuda_time(lambda: run(loop_steps), 1)
    loop_us, busy_us, idle, window, breakdown = {}, {}, {}, {}, {}
    for k, run in loops.items():
        loop_us[k] = min(lt[k]) / loop_steps * 1e3
        for _ in range(fused_timing.PROFILE_TRIES):  # a window can be empty
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(steps_w)
                torch.cuda.synchronize()
                window[k] = time.perf_counter() - t0
            events = [(e.key, e.count, fused_timing.device_total(e))
                      for e in prof.key_averages()
                      if fused_timing.device_total(e) > 0]
            busy_us[k] = sum(t for _, _, t in events) / steps_w
            if busy_us[k] > 0:
                break
        check(busy_us[k] > 0, f"the profiler saw no device time in "
              f"{fused_timing.PROFILE_TRIES} windows of the per-step loop "
              f"({k})")
        idle[k] = 1.0 - busy_us[k] / loop_us[k]  # the profiler slows the host
        # where a step's device time goes: the solve, the step head and
        # tail, the copies, the rest
        part = {"solve": 0.0, "head": 0.0, "tail": 0.0, "copies": 0.0,
                "other": 0.0}
        n_by = dict.fromkeys(part, 0)
        for key, cnt, t in events:
            kind = ("solve" if "solve_" in key else
                    "head" if "step_head" in key else
                    "tail" if "step_tail" in key else
                    "copies" if "memcpy" in key.lower() else "other")
            part[kind] += t / steps_w
            n_by[kind] += cnt
        breakdown[k] = (part, n_by)
    print(f"timing [{card}]: per-step loop, simulate(backend='cuda') as "
          f"CUDA graphs of {graph_steps} steps {loop_us['graphs']:.2f} us/step by CUDA events over "
          f"{loop_steps} steps, runs {[round(t, 1) for t in lt['graphs']]} "
          f"ms ({loop_wall / STEPS * 1e6:.2f} us/step by wall clock over "
          f"phase 8's {STEPS}, captures included: "
          + ", ".join(f"{n} steps {t:.3f} s" for n, t in
                      sorted(captures.items()))
          + f"); eager chunked loop (_step_loop(graphs=False)) "
          f"{loop_us['eager']:.2f} us/step, runs "
          f"{[round(t, 1) for t in lt['eager']]} ms; sim_kernel "
          f"{kern_ms * 1e3:.2f} us/step")
    for k in loops:
        part, n_by = breakdown[k]
        print(f"timing [{card}]: per-step loop ({k}): device busy "
              f"{busy_us[k]:.2f} us/step in a profiled {steps_w}-step window "
              f"({window[k] / steps_w * 1e6:.2f} us/step under the "
              f"profiler; solve_tile_kernel {part['solve']:.2f}, "
              f"step_head_kernel {part['head']:.2f} "
              f"({n_by['head'] / steps_w:.4f} a step), step_tail_kernel "
              f"carrying the next head {part['tail']:.2f}, copies "
              f"{part['copies']:.2f}, {n_by['other'] / steps_w:.2f} other "
              f"kernels {part['other']:.2f} us/step); idle share "
              f"{idle[k]:.3f} of "
              f"the unprofiled {loop_us[k]:.2f} us/step"
              + (" (below 0: the profiled kernels ran longer than the "
                 "unprofiled steps, so the device did not idle)"
                 if idle[k] < 0 else ""))
    bt = cuda_time(run_batch, 3)
    rate = BATCH * BATCH_STEPS / (min(bt) / 1e3)
    print(f"timing [{card}]: batch {BATCH} x {BATCH_STEPS} steps "
          f"{min(bt):.2f} ms (runs {[round(t, 2) for t in bt]}), "
          f"{min(bt) / BATCH_STEPS * 1e3:.2f} us/step, "
          f"{rate:,.0f} scenario-steps/s")
    # a launch's device time: the head's one a chunk, the tail's one a step
    part, n_by = breakdown["graphs"]
    check(part["head"] > 0 and part["tail"] > 0 and n_by["head"] > 0
          and n_by["tail"] > 0, "the profiled graph loop showed no "
          "step_head_kernel or step_tail_kernel time")
    head_ms = part["head"] * steps_w / n_by["head"] / 1e3
    tail_ms = part["tail"] * steps_w / n_by["tail"] / 1e3
    # the step kernels' plain versions at the main path's shape, a call
    st1 = loop._as_batch(final_p)._replace(
        seed=torch.zeros(1, dtype=torch.int64, device=device))
    ph = cuda_step.step_head_plain(cfg, ref, st1.q, st1.dq, st1.mppi.wp_idx)
    u_seq1, s1, _ = _solve_kernels(arm, cfg, ph[0], st1.mppi.u_prev, ph[3],
                                   st1.seed, None, st1.step, False)
    row1 = tuple(r[0] for r in loop._row_buffers(1, st1, ref))
    tail_args = (arm, cfg, sim, ref, *loop._state_tensors(st1)[:5], st1.done,
                 ph[1], ph[2], u_seq1, s1, st1.step.clone(), row1)
    plain_head_ms = min(cuda_time(lambda: [cuda_step.step_head_plain(
        cfg, ref, st1.q, st1.dq, st1.mppi.wp_idx) for _ in range(20)],
        3)) / 20
    plain_tail_ms = min(cuda_time(lambda: [cuda_step.step_tail_plain(
        *tail_args, carry_head=True) for _ in range(20)], 3)) / 20
    print(f"timing [{card}]: the step kernels at benchmark_preset B=1, "
          f"device time a launch in the graph loop: step_head_kernel "
          f"{head_ms * 1e3:.3f} us (one a chunk of {graph_steps} steps), "
          f"step_tail_kernel carrying the next head {tail_ms * 1e3:.3f} "
          f"us; their plain versions (CUDA events over 20 calls, min of 3; "
          f"the tail's followed by the plain head on its outputs) "
          f"{plain_head_ms * 1e3:.2f} us and {plain_tail_ms * 1e3:.2f} us")

    # ---- 11. the fleet kernel against the fused kernel and its twin ----
    fleet_err = 0.0
    for noise in ("eps", "prng"):
        for label, (a, c, s), B, g, r, mix in (
                ("K=128 T=30 B=64 group=8", (arm, cfg_b, sim), 64, 8,
                 ref_b[:120].contiguous(), True),
                ("K=100 T=30 B=12 group=4", m.circle_tracking_preset(), 12,
                 4, ref_b, False),
                ("K=20 T=31 B=16 group=8", (arm, dataclasses.replace(
                    cfg_b, num_samples=20, horizon=31), sim), 16, 8,
                 ref_b[:120].contiguous(), True),
                ("K=90 T=25 B=16 group=8", (arm, dataclasses.replace(
                    cfg_b, num_samples=90, horizon=25), sim), 16, 8, ref_b,
                 False)):
            fleet_err = max(fleet_err, fleet_compare(
                f"fleet {noise} {label}", cuda_sim, a, c, s, r, B, g,
                device, noise, mix))

    # ---- 12. the fleet path --------------------------------------------
    cuda_sim.FLEET_LAUNCHES = 0
    peak_of = peak_memory(torch, device)
    final_f, rec_f = m.simulate_fused_batch(arm, cfg_b, sim, ref_b, states_b,
                                            FLEET_STEPS)
    torch.cuda.synchronize()
    peak_f = peak_of()
    fleet_launches = cuda_sim.FLEET_LAUNCHES
    check(fleet_launches >= 1, "the fleet path launched no fleet kernel")
    print(f"fleet path: simulate_fused_batch {BATCH} scenarios x "
          f"{FLEET_STEPS} steps (K=128, T=30), fleet_kernel launches "
          f"{fleet_launches}")
    for field, v in zip(rec_f._fields, rec_f):
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"fleet {field} not finite")
    check(tuple(rec_f.q.shape) == (FLEET_STEPS, BATCH, 2),
          f"fleet record shape {tuple(rec_f.q.shape)}")
    _, rec_1f = m.simulate_fused(arm, cfg_b, sim, ref_b, one, FLEET_STEPS)
    for field, a, b in zip(rec_f._fields, rec_f, rec_1f):
        check(torch.equal(a[:, 0], b),
              f"fleet scenario 0 {field} differs from its simulate_fused run")
    # every scenario against the fused kernel (group 1) on the same grid
    final_k1, rec_k1 = m.simulate_fused_batch(arm, cfg_b, sim, ref_b,
                                              states_b, FLEET_STEPS, group=1)
    for field, a, b in zip(rec_f._fields, rec_f, rec_k1):
        differ = int((a != b).reshape(FLEET_STEPS, BATCH, -1).any(-1)
                     .any(0).sum())
        check(differ == 0, f"fleet {field} differs from the fused kernel's "
              f"in {differ} of {BATCH} scenarios")
    check(torch.equal(final_k1.mppi.u_prev, final_f.mppi.u_prev)
          and torch.equal(final_k1.step, final_f.step),
          "fleet final state differs from the fused kernel's")
    del final_k1, rec_k1
    half = FLEET_STEPS // 2
    s_h, r_h1 = m.simulate_fused_batch(arm, cfg_b, sim, ref_b, states_b, half)
    s_h2, r_h2 = m.simulate_fused_batch(arm, cfg_b, sim, ref_b, s_h,
                                        FLEET_STEPS - half)
    for field, a, b1, b2 in zip(rec_f._fields, rec_f, r_h1, r_h2):
        b = torch.cat([b1, b2])
        if field == "ref_xy":
            # a frozen scenario's step stops, so its later reference rows
            # are indexed from where it froze; compare the live rows
            live = ~rec_f.done
            a, b = a[live], b[live]
        check(torch.equal(a, b),
              f"fleet chained record {field} differs from one run")
    check(torch.equal(s_h2.mppi.u_prev, final_f.mppi.u_prev)
          and torch.equal(s_h2.q, final_f.q)
          and torch.equal(s_h2.step, final_f.step),
          "fleet chained final state differs from one run")
    compare_records("fleet vs per-step batch, scenario 0",
                    m.SimRecord(*(f[:, 0] for f in rec_f)),
                    m.SimRecord(*(f[:, 0] for f in rec_b)))
    onp = onpath_by_scenario_mm(rec_f, m.synth_circle_path(2000)[:, 0:2])
    n_frozen = int(final_f.done.sum())
    print(f"fleet path: scenario 0 == simulate_fused alone, bitwise; "
          f"all {BATCH} scenarios == the fused kernel's (group 1) run, "
          f"bitwise; {half} + {FLEET_STEPS - half} chained == one run, "
          f"bitwise; "
          f"on-path mean over live steps, by scenario: median "
          f"{np.median(onp):.3f} mm, p95 {np.percentile(onp, 95):.3f} mm "
          f"(not gated); {n_frozen} of {BATCH} scenarios at the path end; "
          f"peak device memory {peak_f / 1e9:.3f} GB above what was "
          f"allocated before")

    # ---- 13. the CLI ---------------------------------------------------
    from mppi_robotarm_tpu_torch import cli

    cli_dir = os.path.join(ROOT, "build", "chip_smoke_cli")   # gitignored
    shutil.rmtree(cli_dir, ignore_errors=True)
    sub = lambda name: os.path.join(cli_dir, name)

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"cli {argv} returned {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    cuda_sim.FLEET_LAUNCHES = 0
    summ = run_cli(["--batch", str(BATCH), "--samples", "128", "--horizon",
                    "30", "--steps", str(CLI_STEPS), "--backend",
                    "cuda-fused", "--out-dir", sub("batch")])
    cli_fleet = cuda_sim.FLEET_LAUNCHES
    check(cli_fleet >= 1, "cli --batch cuda-fused launched no fleet kernel")
    with np.load(sub("batch/batch_record.npz")) as z:
        check(sorted(z.files) == sorted(m.SimRecord._fields)
              and z["q"].shape == (CLI_STEPS, BATCH, 2)
              and np.isfinite(z["q"]).all(), "cli batch_record.npz")
    print(f"cli --batch {BATCH} --backend cuda-fused: fleet_kernel launches "
          f"{cli_fleet}; {json.dumps(summ)}")
    cuda_sim.LAUNCHES = 0
    summ = run_cli(["--steps", str(CLI_STEPS), "--backend", "cuda-fused",
                    "--out-dir", sub("single")])
    check(cuda_sim.LAUNCHES >= 1, "cli cuda-fused launched no sim_kernel")
    print(f"cli --backend cuda-fused: sim_kernel launches "
          f"{cuda_sim.LAUNCHES}; {json.dumps(summ)}")
    cuda_solve.LAUNCHES = 0
    per = ["--backend", "cuda", "--steps"]
    summ = run_cli(per + [str(2 * CKPT_EVERY), "--checkpoint-every",
                          str(CKPT_EVERY), "--checkpoint", sub("full.npz"),
                          "--out-dir", sub("full")])
    check(cuda_solve.LAUNCHES >= 2 * CKPT_EVERY,
          "cli --backend cuda launched too few solves")
    run_cli(per + [str(CKPT_EVERY), "--checkpoint", sub("part.npz"),
                   "--out-dir", sub("first")])
    run_cli(per + [str(CKPT_EVERY), "--checkpoint", sub("part.npz"),
                   "--out-dir", sub("resumed")])
    with np.load(sub("full/record.npz")) as full, \
            np.load(sub("first/record.npz")) as first, \
            np.load(sub("resumed/record.npz")) as resumed:
        for f in m.SimRecord._fields:
            check(np.array_equal(full[f], np.concatenate([first[f],
                                                          resumed[f]])),
                  f"cli resumed record {f} differs from the full run")
    with np.load(sub("full.npz")) as a, np.load(sub("part.npz")) as b:
        check(sorted(a.files) == sorted(b.files)
              and all(np.array_equal(a[f], b[f]) for f in a.files),
              "cli resumed checkpoint differs from the full run's")
    print(f"cli --backend cuda: {CKPT_EVERY} + {CKPT_EVERY} steps through a "
          f"checkpoint == {2 * CKPT_EVERY} uninterrupted, bitwise; "
          f"{json.dumps(summ)}")
    shutil.rmtree(cli_dir, ignore_errors=True)

    # ---- 14. fleet timing ----------------------------------------------
    warps = cuda_sim.fleet_warps(cfg_b.num_samples)
    per_lane = -(-(-(-cfg_b.num_samples // 32)) // warps)
    k3_sass = next(v for k, v in sass_loops.functions(
        sass_loops.library_sass()).items() if "fleet_kernel" in k
        and sass_loops.template_args(k) == f"<{warps},{per_lane}>")
    k3_loop = sass_loops.loop_classes(k3_sass)
    check(k3_loop, "no rollout loop in fleet_kernel's SASS")
    print(f"fleet layout: fleet_kernel<{warps},{per_lane}>, {warps} warps a "
          f"scenario, {per_lane} samples a lane, "
          f"{min(8, cuda_sim.FLEET_MAX_WARPS // warps)} scenarios a block; "
          f"its rollout loop holds {k3_loop['local load']} local loads and "
          f"{k3_loop['local store']} local stores (SASS, static)")
    fleet_args = (arm, cfg_b, sim, ref_b, states_b.q, states_b.dq,
                  states_b.mppi.u_prev.contiguous(), states_b.mppi.wp_idx,
                  states_b.seed)
    out = {}
    run_g = lambda g: out.__setitem__(g, cuda_sim.fused_sim_run_batched(
        *fleet_args, FLEET_TIME_STEPS, step0=states_b.step, group=g))
    t_fleet, t_k1 = [], []
    for _ in range(3):
        t_fleet += cuda_time(lambda: run_g(8), 1)
        t_k1 += cuda_time(lambda: run_g(1), 1)
    fleet_ms = min(t_fleet) / FLEET_TIME_STEPS
    k1_fleet_ms = min(t_k1) / FLEET_TIME_STEPS
    for part, a, b in zip(("records", "u_final"), out[8], out[1]):
        differ = int((a != b).reshape(BATCH, -1).any(-1).sum())
        check(differ == 0, f"fleet timing run: {part} of fleet_kernel != "
              f"sim_kernel's in {differ} of {BATCH} scenarios")
    print(f"fleet timing run: records and u_final of all {BATCH} scenarios "
          f"over {FLEET_TIME_STEPS} steps == sim_kernel's, bitwise")
    fleet_live = int((out[8][0][..., 7] == 0).sum())   # frozen steps skip
    del out
    fleet_err = max(fleet_err, stacked_bands(
        f"fleet prng {BATCH} x K=128 T=30 group=8",
        cuda_sim.fused_sim_run_batched(*fleet_args, CMP_STEPS,
                                       step0=states_b.step, group=8)[0],
        cuda_sim.fused_sim_reference_stacked(*fleet_args, CMP_STEPS,
                                             step0=states_b.step)[0]))
    pt = cuda_time(lambda: cuda_sim.fused_sim_reference_stacked(
        *fleet_args, PLAIN_FLEET_STEPS, step0=states_b.step), 2)
    plain_fleet_ms = min(pt) / PLAIN_FLEET_STEPS
    rate_f = BATCH / (fleet_ms / 1e3)
    print(f"timing [{card}]: fleet {BATCH} x K=128, T=30 over "
          f"{FLEET_TIME_STEPS} steps: fleet_kernel {fleet_ms * 1e3:.2f} "
          f"us/launch-step ({rate_f:,.0f} scenario-steps/s), runs "
          f"{[round(t, 2) for t in t_fleet]} ms; sim_kernel on the same "
          f"fleet {k1_fleet_ms * 1e3:.2f} us/launch-step "
          f"({BATCH / (k1_fleet_ms / 1e3):,.0f} scenario-steps/s), runs "
          f"{[round(t, 2) for t in t_k1]} ms; simulate_batch(cuda) "
          f"{rate:,.0f} scenario-steps/s (phase 10); stacked plain twin "
          f"{plain_fleet_ms * 1e3:.1f} us/step over {PLAIN_FLEET_STEPS} "
          f"steps, runs {[round(t, 2) for t in pt]} ms")

    # ---- 15. the launch-overhead probes and chains ---------------------
    from mppi_robotarm_tpu_torch.ops import cuda_probe

    xp = torch.as_tensor(np.random.default_rng(15).normal(
        size=(8, 128)).astype(np.float32), device=device)
    before = (cuda_probe.SCALE_LAUNCHES, cuda_probe.BIG_LAUNCHES)
    o1 = cuda_probe.probe_scale(xp)
    o2, b2 = cuda_probe.probe_big(xp)
    torch.cuda.synchronize()
    check((cuda_probe.SCALE_LAUNCHES, cuda_probe.BIG_LAUNCHES)
          == (before[0] + 1, before[1] + 1), "a probe launch was not counted")
    want = cuda_probe.probe_scale_reference(xp)
    check(torch.equal(o1, want), "probe_scale_kernel differs from its plain "
          "version")
    check(torch.equal(o2, want) and tuple(b2.shape) == cuda_probe.BIG_SHAPE
          and torch.equal(b2, cuda_probe.probe_big_reference(xp)[1]),
          "probe_big_kernel differs from its plain version")
    odd = (97, 132)        # 3,201 16-byte stores, no whole pass
    o3, b3 = cuda_probe.probe_big(xp, big_shape=odd)
    torch.cuda.synchronize()
    check(torch.equal(o3, want) and torch.equal(
        b3, cuda_probe.probe_big_reference(xp, odd)[1]),
        f"probe_big_kernel differs from its plain version at {odd}")
    probe_err = float(max((o1 - want).abs().max(), (o2 - want).abs().max(),
                          b2.abs().max(), b3.abs().max()))
    print(f"probes: probe_scale_kernel and probe_big_kernel == their plain "
          f"versions, bitwise, at (8, 128); probe_big_kernel also with zeros "
          f"of {odd}")
    # this slice's path: the chains of python -m ...tools.overhead
    cuda_probe.SCALE_LAUNCHES = cuda_probe.BIG_LAUNCHES = 0
    chain_times = overhead.measure(device)
    torch.cuda.synchronize()
    scale_launches = cuda_probe.SCALE_LAUNCHES
    big_launches = cuda_probe.BIG_LAUNCHES
    check(scale_launches >= 1 and big_launches >= 1,
          "the overhead chains launched no probe kernel")
    for cname, t in chain_times:
        print(f"timing [{card}]: " + overhead.format_line(cname, t))
        check(overhead.same_bits(t.eager_carry, t.graph_carry),
              f"chain {cname}: the graph's carry differs from the eager one")
        check(t.launches >= 1, f"chain {cname}: the profiler saw no launch")
    print(f"chains: probe_scale_kernel launches {scale_launches}, "
          f"probe_big_kernel launches {big_launches} (eager chains and one "
          f"capture each; {chain_times[0][1].replays} graph replays a chain "
          f"not counted); every graph == its eager chain, bitwise")

    by_events = []

    def device_ms(name, fn):
        """Device time per call (``fused_timing.profiled_us`` over
        PROBE_TIME_CALLS calls): each kernel's mean time a launch, summed
        over the kernels of fn, which launches each once.  Where no
        profiled window saw a device event, the CUDA-event time per call
        over as many calls, and ``name`` is listed as timed so."""
        us = fused_timing.profiled_us(fn, PROBE_TIME_CALLS)
        if us:
            return sum(us.values()) / 1e3
        by_events.append(name)
        return min(cuda_time(lambda: [fn() for _ in range(PROBE_TIME_CALLS)],
                             3)) / PROBE_TIME_CALLS

    p1_ms = device_ms("probe_scale_kernel",
                      lambda: cuda_probe.probe_scale(xp))
    p1_plain_ms = device_ms("probe_scale plain",
                            lambda: cuda_probe.probe_scale_reference(xp))
    p1_lib_ms = device_ms("torch.mul", lambda: torch.mul(xp, 1.000001))
    p2_ms = device_ms("probe_big_kernel", lambda: cuda_probe.probe_big(xp))
    p2_plain_ms = device_ms("probe_big plain",
                            lambda: cuda_probe.probe_big_reference(xp))
    print(f"timing [{card}]: device time per call over {PROBE_TIME_CALLS} "
          f"calls: probe_scale_kernel {p1_ms * 1e3:.3f} us (the scalar "
          f"design, kept: one-block and one-warp float4 designs measured "
          f"slower, PERF.md), plain "
          f"{p1_plain_ms * 1e3:.3f} us, torch.mul {p1_lib_ms * 1e3:.3f} us; "
          f"probe_big_kernel {p2_ms * 1e3:.3f} us, plain "
          f"{p2_plain_ms * 1e3:.3f} us"
          + (f"; by CUDA events, as {fused_timing.PROFILE_TRIES} profiled "
             f"windows saw no device time: {', '.join(by_events)}"
             if by_events else ""))

    # ---- 16. the sample-sharded solve, in one process ------------------
    from mppi_robotarm_tpu_torch.models.arm import fk_full
    from mppi_robotarm_tpu_torch.parallel import dryrun, sharded

    shard_err = 0.0
    for B in (1, 8):
        for S in (2, 4):
            for noise in ("eps", "prng"):
                shard_err = max(shard_err, *shard_compare(
                    f"sharded solve {noise} K=1024 H=50 B={B} S={S}",
                    cuda_solve, sharded, arm, cfg_w, ref, B, S, device, rng,
                    noise))

    # ---- 17. real 2-process runs on cuda:0 over gloo -------------------
    dr_root = os.path.join(ROOT, "build", "chip_smoke_dryrun")  # gitignored
    shutil.rmtree(dr_root, ignore_errors=True)

    def run_dryrun(name, data, samples, *programs, extra=()):
        out_dir = os.path.join(dr_root, name)
        t0 = time.perf_counter()
        rc = dryrun.main(["--world", "2", "--data", str(data), "--samples",
                          str(samples), "--device", "cuda", "--out", out_dir,
                          "--size", "full", "--programs", *programs, *extra])
        check(rc == 0, f"dryrun {name} exited {rc}")
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(2)]
        check(not any(bool(z["jax_imported"]) for z in ranks),
              f"dryrun {name}: a rank imported JAX")
        return ranks, time.perf_counter() - t0

    (_, _, (cfg_s, path_s, _, steps_s), (cfg_fl, _, fleet_b, fleet_n)) = \
        dryrun.problem("full", 1, 2)
    ranks, wall = run_dryrun("1x2", 1, 2, "step-cuda", "step-plain")
    step_fields = ("q", "u0", "wp_idx", "done", "final_dq", "final_u_prev",
                   "final_step")
    for f in step_fields:
        check(np.array_equal(ranks[0][f"step-cuda_{f}"],
                             ranks[1][f"step-cuda_{f}"]),
              f"sharded step: the two sample shards hold different {f}")
        # the same step through the plain versions of the step kernels
        for z in ranks:
            check(np.array_equal(z[f"step-cuda_{f}"], z[f"step-plain_{f}"]),
                  f"sharded step rank {int(z['samples_rank'])}: {f} differs "
                  f"from the plain versions' step")
    # each kernel's launches each rank counted in its step loop: one a step
    # on the kernels' step; the plain versions' step launches the solve
    by_rank = {name: [int(z[f"step-cuda_{name}_launches"]) for z in ranks]
               for name in dryrun.LAUNCH_COUNTS}
    plain_by_rank = {name: [int(z[f"step-plain_{name}_launches"])
                            for z in ranks]
                     for name in dryrun.LAUNCH_COUNTS}
    check(all(v == [steps_s, steps_s] for v in by_rank.values()),
          f"sharded step: launches by rank {by_rank}, expected one of each "
          f"a step ({steps_s})")
    check(plain_by_rank == {name: [steps_s if name == "solve" else 0] * 2
                            for name in by_rank},
          f"sharded step through the plain versions: launches by rank "
          f"{plain_by_rank}")
    plain_us = [float(r["step-plain_us_per_step"]) for r in ranks]
    ref_s = torch.as_tensor(path_s, device=device)
    _, rec_s = m.simulate(arm, cfg_s, sim, ref_s, state0, CMP_STEPS,
                          backend="cuda")
    z = ranks[0]
    q_s = torch.as_tensor(z["step-cuda_q"][:, 0], device=device)
    u_s = torch.as_tensor(z["step-cuda_u0"][:, 0], device=device)
    dq_s = (q_s[:CMP_STEPS] - rec_s.q).abs().amax(1).cpu().numpy()
    du_s = (u_s[:CMP_STEPS] - rec_s.u).abs().amax(1).cpu().numpy()
    for i in range(CMP_STEPS):
        check(dq_s[i] <= Q_TOL * 4 ** i and du_s[i] <= U_TOL * 4 ** i,
              f"sharded step {i}: q off by {dq_s[i]}, u by {du_s[i]} from "
              f"simulate(backend='cuda')")
    check(np.array_equal(z["step-cuda_wp_idx"][:CMP_STEPS, 0],
                         rec_s.wp_idx.cpu().numpy()),
          "sharded step: wp_idx differs from simulate(backend='cuda')")
    _, _, x2s, y2s = fk_full(q_s[:, 0], q_s[:, 1], arm)
    onpath_s, n_live_s = fused_timing.live_onpath_mm(
        types.SimpleNamespace(ee=torch.stack([x2s, y2s], -1),
                              done=torch.as_tensor(z["step-cuda_done"][:, 0])),
        path_s[:, 0:2])
    check(np.isfinite(z["step-cuda_q"]).all(), "sharded step not finite")
    check(onpath_s < ONPATH_GATE_MM, f"sharded step on-path {onpath_s:.3f}")
    step_us = [float(r["step-cuda_us_per_step"]) for r in ranks]
    coll_us = [float(r["step-cuda_collective_us_per_solve"]) for r in ranks]
    print(f"sharded step [{card}]: mesh 1x2 (data x samples) on cuda:0 over "
          f"gloo, benchmark_preset, {steps_s} steps on a {len(path_s)}-point "
          f"path, PRNG: both shards hold the same block; first {CMP_STEPS} "
          f"steps within phase 2's bands of simulate(backend='cuda') (max|dq| "
          f"{np.array2string(dq_s, precision=2)}); on-path mean "
          f"{onpath_s:.3f} mm over {n_live_s} live steps (gate "
          f"{ONPATH_GATE_MM} mm); {step_us[0]:.1f} / {step_us[1]:.1f} us/step "
          f"by rank, the 2 all-reduces {coll_us[0]:.1f} / {coll_us[1]:.1f} "
          f"us a solve (device synchronised around each); launches by rank "
          f"(counted in the ranks): " + ", ".join(
              f"{name} {v[0]} / {v[1]}" for name, v in by_rank.items())
          + f"; rows (q, u0, wp_idx, done) and final dq, u_prev, step == "
          f"the same step through the plain versions of the step kernels "
          f"(step-plain, {plain_us[0]:.1f} / {plain_us[1]:.1f} us/step), "
          f"bitwise; {wall:.1f} s with the ranks' start")
    ranks, wall = run_dryrun("2x1", 2, 1, "fleet")
    b_loc = fleet_b // 2
    check(cfg_fl == cfg_b and fleet_n == FLEET_STEPS and fleet_b == BATCH,
          "the dryrun's fleet is not phase 12's")
    for z in ranks:
        d = int(z["data_rank"])
        rows = slice(d * b_loc, (d + 1) * b_loc)
        for f in dryrun.FLEET_FIELDS:
            check(np.array_equal(z[f"fleet_{f}"],
                                 getattr(rec_f, f)[:, rows].cpu().numpy()),
                  f"sharded fleet rank {d}: {f} != the unsharded fleet's")
        check(np.array_equal(z["fleet_u_final"],
                             final_f.mppi.u_prev[rows].cpu().numpy())
              and np.array_equal(z["fleet_step"],
                                 final_f.step[rows].cpu().numpy()),
              f"sharded fleet rank {d}: final state != the unsharded fleet's")
        check(bool(z["fleet_checkpoint_bitwise"]),
              f"sharded fleet rank {d}: checkpoint round trip not bitwise")
    fleet_us = [float(z["fleet_us_per_launch_step"]) for z in ranks]
    fleet_peak = [int(z["fleet_peak_bytes"]) for z in ranks]
    print(f"sharded fleet [{card}]: mesh 2x1 on cuda:0 over gloo, {BATCH} x "
          f"K=128, T=30, {FLEET_STEPS} steps, {b_loc} scenarios a rank: each "
          f"rank's records, u_final and step == its rows of phase 12's "
          f"unsharded simulate_fused_batch, bitwise; dist checkpoint round "
          f"trip bitwise; {fleet_us[0]:.2f} / {fleet_us[1]:.2f} us per "
          f"launch-step by rank with both ranks on the card (phase 14: "
          f"{fleet_ms * 1e3:.2f} for all {BATCH} alone); peak device memory "
          f"by rank {fleet_peak[0] / 1e9:.3f} / {fleet_peak[1] / 1e9:.3f} "
          f"GB; {wall:.1f} s with the ranks' start")
    del ranks

    # ---- 18. the debug path on the card --------------------------------
    from mppi_robotarm_tpu_torch.utils.debug import checked_solve, debug_mode

    obs_p = torch.cat([final_p.q, final_p.dq])
    err, res_c = checked_solve(arm, cfg, ref, obs_p, final_p.mppi,
                               backend="cuda", seed=0, step=final_p.step)
    check(err.get() is None and bool(torch.isfinite(res_c.u0).all()),
          f"checked_solve mid-path: {err.get()}")
    # two rows before the end of the circle cut at its first closing row,
    # the EE at the circle's start (= its end): the index reaches the end
    # (on the whole circle the closing rows tie in x, y and the first wins,
    # the reference's tie rule, so the index stays below the end there)
    xy_moves = np.any(np.diff(path_np[:, :2], axis=0) != 0, axis=1)
    cut = torch.as_tensor(path_np[:np.flatnonzero(xy_moves).max() + 2],
                          device=device)
    err_end, res_end = checked_solve(
        arm, cfg, cut, torch.cat([state0.q, state0.dq]),
        state0.mppi._replace(wp_idx=torch.tensor(len(cut) - 2,
                                                 device=device)),
        backend="cuda", seed=0)
    check(int(res_end.state.wp_idx) == len(cut) - 1,
          f"checked_solve near the end: index {int(res_end.state.wp_idx)}, "
          f"not the last row {len(cut) - 1}")
    poisoned = state0.mppi._replace(
        u_prev=torch.full_like(state0.mppi.u_prev, float("nan")))
    err_nan, _ = checked_solve(arm, cfg, ref, obs_p, poisoned, backend="cuda",
                               seed=0)
    for e, kind in ((err_end, IndexError), (err_nan, FloatingPointError)):
        try:
            e.throw()
        except kind as raised:
            print(f"checked_solve(backend='cuda'): raised {kind.__name__}: "
                  f"{raised}")
        else:
            raise RuntimeError(f"checked_solve did not raise {kind.__name__}")
    with debug_mode():
        _, rec_d = m.simulate(arm, cfg, sim, ref, state0, 2 * graph_steps,
                              backend="cuda")
    check(all(torch.equal(a, b[:2 * graph_steps])
              for a, b in zip(rec_d, rec_p)),
          "debug_mode changed the graph loop's records")
    print(f"debug: checked_solve(backend='cuda') clean mid-path (step "
          f"{int(final_p.step)}), raises at the path end and on a NaN "
          f"u_prev; the graph loop under debug_mode (checks between chunks) "
          f"== phase 8's records over {2 * graph_steps} steps, bitwise")

    # ---- 19. pathgen and compat on the card ----------------------------
    from mppi_robotarm_tpu_torch.compat import (Arm_Dynamic,
                                                MPPIControllerForPathTracking)
    from mppi_robotarm_tpu_torch.ops import cuda_pathgen
    from mppi_robotarm_tpu_torch.sim.pathgen import (circle_targets,
                                                     generate_circle_path)

    def in_bands(d):
        return d[0:2].max() <= 1e-6 and d[2:4].max() <= 1e-5 \
            and d[4:6].max() <= 1e-3

    t0 = time.perf_counter()
    generate_circle_path(arm, PATHGEN_STEPS)     # the first call
    torch.cuda.synchronize()
    gen_first_s = time.perf_counter() - t0
    cuda_pathgen.LAUNCHES = 0
    t0 = time.perf_counter()
    gen = generate_circle_path(arm, PATHGEN_STEPS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    g1_launches = cuda_pathgen.LAUNCHES
    check(g1_launches == 1, f"generate_circle_path on cuda made "
          f"{g1_launches} pathgen_kernel launches, not one")
    # no per-step loop: the call's device events do not grow with the steps
    gen_events = {}
    for n in (PATHGEN_STEPS, 2 * PATHGEN_STEPS):
        for _ in range(fused_timing.PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                generate_circle_path(arm, n)
                torch.cuda.synchronize()
            gen_events[n] = sum(e.count for e in prof.key_averages()
                                if fused_timing.device_total(e) > 0)
            if gen_events[n]:
                break
    check(0 < gen_events[PATHGEN_STEPS]
          and abs(gen_events[2 * PATHGEN_STEPS] - gen_events[PATHGEN_STEPS])
          < PATHGEN_STEPS, f"generate_circle_path on cuda: {gen_events} "
          f"device events by steps, a count that grows with the steps")
    t0 = time.perf_counter()
    gen_cpu = generate_circle_path(arm, PATHGEN_STEPS, device="cpu")
    gen_cpu_s = time.perf_counter() - t0
    dg = (gen.cpu() - gen_cpu).abs().amax(0).numpy()
    check(np.isfinite(gen.cpu().numpy()).all() and in_bands(dg),
          f"generate_circle_path on cuda vs the CPU: max |d| by column {dg}")
    print(f"pathgen: generate_circle_path({PATHGEN_STEPS}) on cuda "
          f"{gen_s * 1e3:.2f} ms (its first call {gen_first_s * 1e3:.2f} "
          f"ms), pathgen_kernel launches {g1_launches}, device events "
          f"{gen_events[PATHGEN_STEPS]} at {PATHGEN_STEPS} steps and "
          f"{gen_events[2 * PATHGEN_STEPS]} at {2 * PATHGEN_STEPS} (the "
          f"targets' batched calls and the kernel); on the CPU "
          f"{gen_cpu_s:.2f} s; max |cuda - cpu| "
          f"by column {np.array2string(dg, precision=2)} (bands x, y 1e-6, "
          f"dq 1e-5, u 1e-3)")
    # the kernel against its plain version on the same card tensors
    g1_err, g1_ms, g1_plain_ms = 0.0, None, None
    for dtype in (torch.float32, torch.float64):
        tgt = circle_targets(PATHGEN_STEPS, 0.003, 2.0 * math.pi / 6.0,
                             dtype, device)
        g1_args = (arm, *tgt, 0.003, 100.0, 20.0)
        k_rows = cuda_pathgen.pathgen(*g1_args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_rows = cuda_pathgen.pathgen_reference(*g1_args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        cpu_args = (arm, *(t.cpu() for t in tgt), 0.003, 100.0, 20.0)
        t0 = time.perf_counter()
        cuda_pathgen.pathgen_reference(*cpu_args)
        plain_cpu_s = time.perf_counter() - t0
        d = (k_rows - p_rows).abs().amax(0).cpu().numpy()
        check(np.isfinite(k_rows.cpu().numpy()).all() and in_bands(d),
              f"pathgen_kernel {dtype} vs its plain version: max |d| by "
              f"column {d}")
        g1_err = max(g1_err, float(d.max()))
        us = fused_timing.profiled_us(lambda: cuda_pathgen.pathgen(*g1_args),
                                      5, lambda k: "pathgen" in k)
        check(bool(us), f"the profiler saw no pathgen_kernel ({dtype})")
        k_ms = sum(us.values()) / 1e3
        if dtype == torch.float32:
            g1_ms, g1_plain_ms = k_ms, plain_s * 1e3
        print(f"timing [{card}]: pathgen_kernel {dtype} at "
              f"{PATHGEN_STEPS} steps: {k_ms:.4f} ms device time a launch "
              f"({k_ms / PATHGEN_STEPS * 1e6:.1f} ns a step); its plain "
              f"version (the torch loop) {plain_s:.3f} s on the card, "
              f"{plain_cpu_s:.3f} s on the CPU; kernel vs plain on the card: "
              + ("bitwise" if torch.equal(k_rows, p_rows) else
                 f"max |d| by column {np.array2string(d, precision=2)}"))
    ref_c = m.synth_circle_path(2000, dtype=np.float64)
    np.random.seed(0)
    ctrl = MPPIControllerForPathTracking(
        delta_t=0.006, ref_path=ref_c, horizon_step_T=30,
        number_of_samples_K=100, param_exploration=0.0, param_lambda=100.0,
        param_alpha=0.98, sigma=np.array([[20.0, 0.0], [0.0, 20.0]]),
        stage_cost_weight=np.array([0.5, 0.5, 5.0, 5.0]),
        terminal_cost_weight=np.array([5.0, 5.0, 50.0, 50.0]))
    launches_c = cuda_solve.LAUNCHES
    qc, dqc, ee_c = np.array([1.1522, -1.2661]), np.zeros(2), []
    for _ in range(20):
        u0c, *_ = ctrl.calc_control_input(np.concatenate([qc, dqc]))
        dqc = dqc + 0.003 * Arm_Dynamic(qc, dqc, u0c)
        qc = qc + 0.003 * dqc
        ee_c.append([np.cos(qc[0]) + np.cos(qc.sum()),
                     np.sin(qc[0]) + np.sin(qc.sum())])
    ee_c = np.asarray(ee_c)
    onpath_c = float(np.linalg.norm(ee_c[:, None] - ref_c[None, :, 0:2],
                                    axis=-1).min(1).mean() * 1e3)
    check(np.isfinite(ee_c).all() and onpath_c < ONPATH_GATE_MM
          and cuda_solve.LAUNCHES - launches_c == 20,
          f"compat on cuda: on-path {onpath_c:.3f} mm, "
          f"{cuda_solve.LAUNCHES - launches_c} solve launches")
    print(f"compat: 20 steps of MPPIControllerForPathTracking(backend='cuda')"
          f" under np.random.seed(0), one solve_kernel launch a step; finite;"
          f" on-path mean {onpath_c:.3f} mm (gate {ONPATH_GATE_MM} mm)")

    # ---- 20. the step kernels against their plain versions -------------
    head_err, step_err = step_compare(
        "step kernels B=1 benchmark_preset", loop, cuda_step, _solve_kernels,
        arm, cfg, sim, ref, loop._as_batch(state0)._replace(
            seed=torch.zeros(1, dtype=torch.int64, device=device)))
    ref200 = ref[:200].contiguous()
    st64 = m.init_sim_batch(cfg, sim, np.arange(64), q0=(
        np.array([sim.q0]) + 0.02 * np.random.default_rng(20).normal(
            size=(64, 2))).astype(np.float32), device=device)
    wp64 = torch.arange(64, device=device) * 3
    wp64[-4:] = torch.tensor([196, 197, 198, 197], device=device)
    st64 = st64._replace(
        mppi=st64.mppi._replace(wp_idx=wp64),
        done=torch.arange(64, device=device) % 8 == 5,
        step=torch.arange(64, device=device) % 5)
    errs = step_compare("step kernels B=64 benchmark_preset", loop,
                        cuda_step, _solve_kernels, arm, cfg, sim, ref200,
                        st64)
    head_err, step_err = max(head_err, errs[0]), max(step_err, errs[1])
    wp_f = final_b.mppi.wp_idx.clone()
    wp_f[-4:] = torch.tensor([1996, 1997, 1998, 1997], device=device)
    st_f = final_b._replace(
        mppi=final_b.mppi._replace(wp_idx=wp_f),
        done=final_b.done | (torch.arange(BATCH, device=device) % 8 == 5))
    errs = step_compare(f"step kernels fleet B={BATCH} K=128 T=30", loop,
                        cuda_step, _solve_kernels, arm, cfg_b, sim, ref_b,
                        st_f)
    head_err, step_err = max(head_err, errs[0]), max(step_err, errs[1])
    print("step kernels: the tail's layout (statistics warps, logical "
          "lanes a lane, scenarios a block, samples a logical lane in "
          "registers): " + "; ".join(
              f"{shape} {cuda_step.step_tail_layout(k, b, sm_count)}"
              for shape, k, b in (("B=1 K=1024", cfg.num_samples, 1),
                                  ("B=64 K=1024", cfg.num_samples, 64),
                                  (f"fleet B={BATCH} K=128", 128, BATCH))))

    # ---- 21. the sharded step's kernels against their plain versions --
    from mppi_robotarm_tpu_torch.ops import cuda_shard

    T = cfg.horizon
    wp_s = torch.arange(64, device=device) * 3
    wp_s[::8] = ref200.shape[0] - 1
    wp_s[-4:] = torch.tensor([196, 197, 198, 197], device=device)
    shard_starts = (
        ("B=1", ref, (state0.q[None], state0.dq[None],
                      state0.mppi.u_prev[None], state0.mppi.wp_idx[None])),
        ("B=64", ref200, (st64.q, st64.dq, st64.mppi.u_prev, wp_s)))
    s34_err = 0.0
    for fw in (1, 10, 2 * T + 3):
        cfg_fw = dataclasses.replace(cfg, filter_window=fw)
        for shape, path, start in shard_starts:
            for noise in ("eps", "prng"):
                s34_err = max(s34_err, shard_step_compare(
                    f"sharded step kernels {shape} {noise} filter_window "
                    f"{fw}", sharded, cuda_solve, arm, cfg_fw, sim, path,
                    start, noise, rng))
    # S3 and S4 at the main path's shape (B=1, T=50, filter_window 10): a
    # launch's device time, and their plain versions' by CUDA events
    sm_a = shard_starts[0][2]
    x0_1, wp1, end1, win1_s = cuda_step.step_head(cfg, ref, *sm_a[:2],
                                                  sm_a[3])
    kl = cfg.num_samples // 2
    parts1 = [cuda_solve.solve_batched(
        arm, cfg, x0_1, sm_a[2], win1_s, emit_eps=False, normalize=False,
        k_local=kl, k_offset=torch.full((1,), r * kl, device=device),
        seed=torch.zeros(1, dtype=torch.int64, device=device),
        step=torch.zeros(1, dtype=torch.int64, device=device))
        for r in range(2)]
    m1s = torch.minimum(parts1[0][3][0], parts1[1][3][0])
    scale_args = (m1s, parts1[0][3][0], parts1[0][3][1], parts1[0][0],
                  cfg.lam)
    # the finish reads the summed message, as the step does
    msg1 = sum(cuda_shard.shard_scale(m1s, p[3][0], p[3][1], p[0], cfg.lam)
               for p in parts1)
    finish_args = (cfg, msg1, sm_a[2])
    scale_ms = sum(fused_timing.profiled_us(
        lambda: cuda_shard.shard_scale(*scale_args), PROBE_TIME_CALLS,
        lambda k: "shard_scale" in k).values()) / 1e3
    finish_ms = sum(fused_timing.profiled_us(
        lambda: cuda_shard.shard_finish(*finish_args), PROBE_TIME_CALLS,
        lambda k: "shard_finish" in k).values()) / 1e3
    check(scale_ms > 0 and finish_ms > 0, "the profiler saw no "
          "shard_scale_kernel or shard_finish_kernel time")
    plain_scale_ms = min(cuda_time(lambda: [cuda_shard.shard_scale_plain(
        *scale_args) for _ in range(20)], 3)) / 20
    plain_finish_ms = min(cuda_time(lambda: [cuda_shard.shard_finish_plain(
        *finish_args) for _ in range(20)], 3)) / 20
    print(f"timing [{card}]: the sharded step's kernels at benchmark_preset "
          f"B=1 (K_local {kl}, T {T}, filter_window {cfg.filter_window}), "
          f"device time a launch: shard_scale_kernel {scale_ms * 1e3:.3f} "
          f"us, shard_finish_kernel {finish_ms * 1e3:.3f} us; their plain "
          f"versions (CUDA events over 20 calls, min of 3) "
          f"{plain_scale_ms * 1e3:.2f} us and {plain_finish_ms * 1e3:.2f} "
          f"us")

    # ---- 22. BASELINE config 5: 32,768 scenarios on one card ------------
    q0_5 = (np.array([[1.1522, -1.2661]])
            + 0.01 * np.random.default_rng(9).normal(size=(CONFIG5, 2)))
    check(np.array_equal(q0_5[:BATCH], q0_b),
          "config 5's first q0 rows are not phase 9's fleet")
    states_5 = m.init_sim_batch(cfg_b, sim, np.arange(CONFIG5),
                                q0=q0_5.astype(np.float32), device=device)
    cap_5 = loop._FUSED_MAX_STEPS // CONFIG5
    want_5 = -(-FLEET_STEPS // cap_5)
    cuda_sim.FLEET_LAUNCHES = 0
    peak_of = peak_memory(torch, device)
    t0 = time.perf_counter()
    final_5, rec_5 = m.simulate_fused_batch(arm, cfg_b, sim, ref_b, states_5,
                                            FLEET_STEPS)
    torch.cuda.synchronize()
    wall_5 = time.perf_counter() - t0
    peak_5 = peak_of()
    launches_5 = cuda_sim.FLEET_LAUNCHES
    check(launches_5 == want_5, f"config 5 fused: {launches_5} fleet_kernel "
          f"launches, not {want_5} of at most {cap_5} steps")
    finite_5 = torch.ones(CONFIG5, dtype=torch.bool, device=device)
    for field, v in zip(rec_5._fields, rec_5):
        check(tuple(v.shape[:2]) == (FLEET_STEPS, CONFIG5),
              f"config 5 fused record {field} shape {tuple(v.shape)}")
        if v.dtype.is_floating_point:
            finite_5 &= torch.isfinite(v).reshape(FLEET_STEPS, CONFIG5,
                                                  -1).all(-1).all(0)
    finite_5 &= torch.isfinite(final_5.q).all(-1)
    for field, a, b in zip(rec_5._fields, rec_5, rec_f):
        check(same_bits(a[:, :BATCH], b), f"config 5 fused {field}: "
              f"scenarios 0-{BATCH - 1} differ from phase 12's run")
    check(all(same_bits(a[:BATCH], b) for a, b in zip(
        loop._state_tensors(final_5), loop._state_tensors(final_f))),
        f"config 5 fused: the final state of scenarios 0-{BATCH - 1} "
        f"differs from phase 12's")

    def alone_5(b):
        """Scenario b of the fleet run alone on the fused kernel, held to
        its rows and final state bit for bit."""
        alone = m.init_sim(cfg_b, sim, seed=b, device=device)._replace(
            q=states_5.q[b])
        fin_1, rec_1 = m.simulate_fused(arm, cfg_b, sim, ref_b, alone,
                                        FLEET_STEPS)
        for field, a, c in zip(rec_5._fields, rec_5, rec_1):
            check(same_bits(a[:, b], c), f"config 5 fused scenario {b} "
                  f"{field} differs from its simulate_fused run alone")
        check(same_bits(fin_1.mppi.u_prev, final_5.mppi.u_prev[b])
              and same_bits(fin_1.q, final_5.q[b])
              and int(fin_1.step) == int(final_5.step[b]),
              f"config 5 fused scenario {b}: final state differs from its "
              f"run alone")

    for b in CONFIG5_SPREAD:
        alone_5(b)
    # a scenario that leaves the finite numbers is one that reached the
    # path's closure rows (synth_circle_path's θ≈2π overrides: the rows
    # there repeat (1.4, 0.8), the index stops at the first of them, whose
    # dq row is the override's jump, 18 rad/s) and diverged there, as it
    # does alone on the fused kernel
    xy_moves = np.any(np.diff(m.synth_circle_path(2000)[:, :2], axis=0) != 0,
                      axis=1)
    closure = int(np.flatnonzero(~xy_moves)[0])
    diverged = []
    for b in (~finite_5).nonzero().flatten().tolist():
        ok_rows = torch.stack([torch.isfinite(v[:, b]).reshape(
            FLEET_STEPS, -1).all(-1) for v in rec_5
            if v.dtype.is_floating_point]).all(0)
        first = int((~ok_rows).nonzero()[0]) if not bool(ok_rows.all()) \
            else FLEET_STEPS
        wp_first = int(rec_5.wp_idx[min(first, FLEET_STEPS - 1), b])
        check(wp_first >= closure, f"config 5 fused scenario {b}: not finite "
              f"from step {first} at waypoint {wp_first}, before the path's "
              f"closure rows ({closure})")
        alone_5(b)
        diverged.append((b, first, wp_first))
    s_h, r_h1 = m.simulate_fused_batch(arm, cfg_b, sim, ref_b, states_5, half)
    s_h2, r_h2 = m.simulate_fused_batch(arm, cfg_b, sim, ref_b, s_h,
                                        FLEET_STEPS - half)
    for field, a, b1, b2 in zip(rec_5._fields, rec_5, r_h1, r_h2):
        b = torch.cat([b1, b2])
        if field == "ref_xy":     # indexed from where a frozen one froze
            a, b = a[~rec_5.done], b[~rec_5.done]
        check(same_bits(a, b),
              f"config 5 fused chained record {field} differs from one run")
    check(all(same_bits(a, b) for a, b in zip(
        loop._state_tensors(s_h2), loop._state_tensors(final_5))),
        "config 5 fused chained final state differs from one run")
    del s_h, r_h1, r_h2, s_h2
    onp_5 = onpath_by_scenario_mm(rec_5, m.synth_circle_path(2000)[:, 0:2])
    # the fleet kernel alone, one launch of CONFIG5_TIME_STEPS steps
    fleet_args_5 = (arm, cfg_b, sim, ref_b, states_5.q, states_5.dq,
                    states_5.mppi.u_prev.contiguous(), states_5.mppi.wp_idx,
                    states_5.seed)
    t_5 = cuda_time(lambda: cuda_sim.fused_sim_run_batched(
        *fleet_args_5, CONFIG5_TIME_STEPS, step0=states_5.step, group=8), 3)
    k3_5_ms = min(t_5) / CONFIG5_TIME_STEPS
    # the path under the profiler: the fleet kernel's device time against
    # the run's, the rest being the launches' time outside the kernel
    for _ in range(fused_timing.PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m.simulate_fused_batch(arm, cfg_b, sim, ref_b, states_5,
                                   FLEET_STEPS)
            torch.cuda.synchronize()
            prof_wall_5 = time.perf_counter() - t0
        k3_dev_5 = [(e.count, fused_timing.device_total(e))
                    for e in prof.key_averages() if "fleet_kernel" in e.key]
        if k3_dev_5:
            break
    check(bool(k3_dev_5), "the profiler saw no fleet_kernel in the config 5 "
          "path")
    k3_dev_s = sum(t for _, t in k3_dev_5) / 1e6
    outside_5 = prof_wall_5 - k3_dev_s
    print(f"config 5 fused [{card}]: simulate_fused_batch {CONFIG5} x "
          f"{FLEET_STEPS} steps (K=128, T=30): {launches_5} fleet_kernel "
          f"launches of at most {cap_5} steps; records "
          f"({FLEET_STEPS}, {CONFIG5}, .); scenarios 0-{BATCH - 1} == phase "
          f"12's run and final state, bitwise; scenarios "
          f"{list(CONFIG5_SPREAD)} == simulate_fused alone, bitwise; {half} + "
          f"{FLEET_STEPS - half} chained == one run, bitwise; records finite "
          f"but for {len(diverged)} scenario(s) (scenario, first non-finite "
          f"step, its waypoint: {diverged}) that reached the closure rows "
          f"from {closure} on and diverged there, each == its run alone, "
          f"bitwise; on-path mean over live steps, by finite scenario: "
          f"median {np.nanmedian(onp_5):.3f} mm, p95 "
          f"{np.nanpercentile(onp_5, 95):.3f} mm (not gated; {BATCH}: "
          f"{np.median(onp):.3f}, {np.percentile(onp, 95):.3f}); "
          f"{int(final_5.done.sum())} at the path end")
    print(f"timing [{card}]: config 5 fleet_kernel, one launch of "
          f"{CONFIG5_TIME_STEPS} steps: {k3_5_ms * 1e3:.2f} us/launch-step "
          f"({CONFIG5 / (k3_5_ms / 1e3):,.0f} scenario-steps/s), runs "
          f"{[round(t, 2) for t in t_5]} ms (phase 14 at {BATCH}: "
          f"{fleet_ms * 1e3:.2f} us/launch-step, {rate_f:,.0f} "
          f"scenario-steps/s); the path: {wall_5:.3f} s wall "
          f"({wall_5 / FLEET_STEPS * 1e6:.2f} us/step) unprofiled, "
          f"{prof_wall_5:.3f} s profiled, of which fleet_kernel device time "
          f"{k3_dev_s:.3f} s in {sum(c for c, _ in k3_dev_5)} launches, "
          f"outside the kernel {outside_5:.3f} s "
          f"({outside_5 / prof_wall_5 * 100:.2f} % of the run, "
          f"{outside_5 / launches_5 * 1e3:.2f} ms a launch); peak device "
          f"memory {peak_5 / 1e9:.3f} GB above what was allocated before "
          f"({BATCH}: {peak_f / 1e9:.3f})")
    # the per-step path
    cuda_solve.LAUNCHES = cuda_solve.COMBINE_LAUNCHES = 0
    cuda_step.HEAD_LAUNCHES = cuda_step.TAIL_LAUNCHES = 0
    cuda_step.CARRIED_HEADS = 0
    run_batch5 = lambda: m.simulate_batch(arm, cfg_b, sim, ref_b, states_5,
                                          BATCH_STEPS, backend="cuda")
    peak_of = peak_memory(torch, device)
    final_b5, rec_b5 = run_batch5()
    torch.cuda.synchronize()
    peak_b5 = peak_of()
    counts_5 = (cuda_solve.LAUNCHES, cuda_solve.COMBINE_LAUNCHES,
                cuda_step.HEAD_LAUNCHES, cuda_step.TAIL_LAUNCHES,
                cuda_step.CARRIED_HEADS)
    chunks_b = -(-BATCH_STEPS // graph_steps)
    check(counts_5 == (BATCH_STEPS, 0, chunks_b, BATCH_STEPS,
                       BATCH_STEPS - chunks_b),
          f"config 5 per-step: (solve, combine, head, tail, carried) "
          f"launches {counts_5}, not a solve and a tail a step and a head a "
          f"chunk")
    for field, v in zip(rec_b5._fields, rec_b5):
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()),
                  f"config 5 per-step {field} not finite")
    for field, a, b in zip(rec_b5._fields, rec_b5, rec_b):
        check(same_bits(a[:, :BATCH], b), f"config 5 per-step {field}: "
              f"scenarios 0-{BATCH - 1} differ from phase 9's run")
    check(all(same_bits(a[:BATCH], b) for a, b in zip(
        loop._state_tensors(final_b5), loop._state_tensors(final_b))),
        f"config 5 per-step: the final state of scenarios 0-{BATCH - 1} "
        f"differs from phase 9's")
    bt_5 = cuda_time(run_batch5, 3)
    print(f"config 5 per-step [{card}]: simulate_batch(backend='cuda') "
          f"{CONFIG5} x {BATCH_STEPS} steps: solve, head, tail launches "
          f"{counts_5[0]}, {counts_5[2]}, {counts_5[3]} ({counts_5[4]} "
          f"carrying the head); finite; scenarios 0-{BATCH - 1} == phase "
          f"9's run and final state, bitwise; {min(bt_5) / BATCH_STEPS * 1e3:.2f}"
          f" us/step ({CONFIG5 * BATCH_STEPS / (min(bt_5) / 1e3):,.0f} "
          f"scenario-steps/s), runs {[round(t, 2) for t in bt_5]} ms "
          f"({BATCH}: {min(bt) / BATCH_STEPS * 1e3:.2f} us/step, phase 10); "
          f"peak device memory {peak_b5 / 1e9:.3f} GB above what was "
          f"allocated before, captures included ({BATCH}: "
          f"{peak_b / 1e9:.3f})")
    del final_b5, rec_b5
    # the (2 x 1) data-sharded fleet, 16,384 scenarios a rank
    ranks, wall = run_dryrun("2x1_config5", 2, 1, "fleet", extra=(
        "--fleet-scenarios", str(CONFIG5)))
    b_5 = CONFIG5 // 2
    for z in ranks:
        d = int(z["data_rank"])
        rows = slice(d * b_5, (d + 1) * b_5)
        for f in dryrun.FLEET_FIELDS:
            check(same_bits(torch.as_tensor(z[f"fleet_{f}"], device=device),
                            getattr(rec_5, f)[:, rows]),
                  f"config 5 sharded fleet rank {d}: {f} != the unsharded "
                  f"fleet's")
        check(same_bits(z["fleet_u_final"],
                        final_5.mppi.u_prev[rows].cpu().numpy())
              and same_bits(z["fleet_step"], final_5.step[rows].cpu().numpy()),
              f"config 5 sharded fleet rank {d}: final state != the "
              f"unsharded fleet's")
        check(bool(z["fleet_checkpoint_bitwise"]),
              f"config 5 sharded fleet rank {d}: checkpoint round trip not "
              f"bitwise")
    us_5 = [float(z["fleet_us_per_launch_step"]) for z in ranks]
    peak_r5 = [int(z["fleet_peak_bytes"]) for z in ranks]
    del ranks
    print(f"config 5 sharded fleet [{card}]: mesh 2x1 on cuda:0 over gloo, "
          f"{CONFIG5} x K=128, T=30, {FLEET_STEPS} steps, {b_5} scenarios a "
          f"rank: each rank's records, u_final and step == its rows of the "
          f"unsharded run, bitwise; checkpoint round trip bitwise; "
          f"{us_5[0]:.2f} / {us_5[1]:.2f} us per launch-step by rank, both "
          f"ranks sharing the one card (not a scaling number; {BATCH}: "
          f"{fleet_us[0]:.2f} / {fleet_us[1]:.2f}); peak device memory by "
          f"rank {peak_r5[0] / 1e9:.3f} / {peak_r5[1] / 1e9:.3f} GB; "
          f"{wall:.1f} s with the ranks' start")
    del rec_5, final_5, states_5

    # ---- 23. the soak: 40,000 steps to a 10-revolution path's end -------
    from mppi_robotarm_tpu_torch.tools import longrun

    path_k = m.synth_circle_path(SOAK_WAYPOINTS, revolutions=SOAK_REVOLUTIONS)
    ref_k = torch.as_tensor(path_k, device=device)
    xy_k = path_k[:, 0:2]
    cuda_sim.LAUNCHES = 0
    soak_fin, soak_rec, soak_s = longrun.run_fused(arm, cfg, sim, ref_k,
                                                   SOAK_STEPS)
    soak_k1 = cuda_sim.LAUNCHES
    check(soak_k1 == 1, f"the soak's fused run made {soak_k1} launches")
    cuda_sim.LAUNCHES = 0
    chain_fin, chain_rec, chain_s = longrun.run_fused(
        arm, cfg, sim, ref_k, SOAK_STEPS, chunks=SOAK_CHUNKS)
    check(cuda_sim.LAUNCHES == SOAK_CHUNKS, f"the soak's chained run made "
          f"{cuda_sim.LAUNCHES} launches, not {SOAK_CHUNKS}")
    for field, a, b in zip(soak_rec._fields, soak_rec, chain_rec):
        if field == "ref_xy":     # indexed from where the run froze
            a, b = a[~soak_rec.done], b[~soak_rec.done]
        check(torch.equal(a, b), f"the soak's {SOAK_CHUNKS} chained runs: "
              f"{field} differs from one launch")
    check(all(torch.equal(a, b) for a, b in zip(
        (soak_fin.step, soak_fin.q, soak_fin.dq, *soak_fin.mppi,
         soak_fin.done),
        (chain_fin.step, chain_fin.q, chain_fin.dq, *chain_fin.mppi,
         chain_fin.done))),
        "the soak's chained final state differs from one launch")
    cuda_solve.LAUNCHES = 0
    cuda_step.HEAD_LAUNCHES = cuda_step.TAIL_LAUNCHES = 0
    graph_fin, graph_rec, graph_s = longrun.run_per_step(arm, cfg, sim, ref_k,
                                                         SOAK_STEPS)
    soak_counts = (cuda_solve.LAUNCHES, cuda_step.HEAD_LAUNCHES,
                   cuda_step.TAIL_LAUNCHES)
    check(soak_counts == (SOAK_STEPS, -(-SOAK_STEPS // graph_steps),
                          SOAK_STEPS),
          f"the soak's graph loop made (solve, head, tail) launches "
          f"{soak_counts}")
    for label, fin, rec_k in (("fused", soak_fin, soak_rec),
                              ("graph loop", graph_fin, graph_rec)):
        c = longrun.soak_checks(fin, rec_k, xy_k)
        first = c["onpath_first_mm"]
        n_first = min(c["live_steps"], longrun.ONPATH_FIRST)
        check(c["finite"], f"soak {label}: a record is not finite")
        check(c["reached_end"] and c["frozen"], f"soak {label}: the path's "
              f"end not reached, or the state not frozen after it: {c}")
        check(c["counter"], f"soak {label}: the step counter "
              f"{int(fin.step)} != the live steps {c['live_steps']}")
        check(first < ONPATH_GATE_MM, f"soak {label}: on-path mean "
              f"{first:.3f} mm over the first {n_first} live steps")
        print(f"soak [{card}]: {label}, benchmark_preset, {SOAK_STEPS} steps "
              f"on a {SOAK_REVOLUTIONS}-revolution {SOAK_WAYPOINTS}-point "
              f"circle: finite; the path's end at step {c['end_step']}, then "
              f"frozen with u and the cost lanes zeroed; step counter "
              f"{int(fin.step)} == the live steps; on-path mean {first:.3f} "
              f"mm over the first {n_first} live steps (gate "
              f"{ONPATH_GATE_MM} mm), {c['onpath_mean_mm']:.3f} mm over all "
              f"{c['live_steps']} (reported)")
    print(f"soak [{card}]: the fused kernel {soak_s:.3f} s in one launch, "
          f"{chain_s:.3f} s in {SOAK_CHUNKS} chained launches (== the one "
          f"launch, bitwise, records and final state); the graph loop "
          f"{graph_s:.3f} s in {soak_counts[1]} chunks")
    for line in longrun.report_lines(longrun.compare(soak_rec, graph_rec,
                                                     xy_k)):
        print(f"soak, fused vs graph loop: {line}")
    del soak_rec, chain_rec, graph_rec

    # ---- 24. the benchmark: python -m mppi_robotarm_tpu_torch.bench -------
    from mppi_robotarm_tpu_torch import bench as port_bench

    # the whole bench: its three backends, the fit when the fused backend
    # wins and the high-accuracy run (some two minutes on an H100 since the
    # eager backend replays CUDA graphs, PERF.md)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mppi_robotarm_tpu_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the bench exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    bench_out = proc.stdout.strip().splitlines()
    line = json.loads(bench_out[-1])
    notes = [ln[2:] for ln in proc.stderr.splitlines() if ln.startswith("# ")]
    best = next(ln.split(": ", 1)[1] for ln in notes
                if ln.startswith("best backend: "))
    rates = {ln.split()[1][:-1]: float(ln.split()[2]) for ln in notes
             if ln.startswith("backend ")}
    want_keys = {"metric", "value", "unit", "vs_baseline", "on_path_mean_mm",
                 "high_accuracy_on_path_mean_mm"} | (
        {"device_us_per_step"} if best == "cuda-fused" else set())
    check(set(rates) == set(port_bench.BACKENDS),
          f"the bench timed {sorted(rates)}, not {port_bench.BACKENDS}")
    check(all(math.isfinite(r) and r > 0 for r in rates.values()),
          f"the bench's solves/s by backend {rates}")
    check(set(line) == want_keys, f"the bench line's keys {sorted(line)}, "
          f"not {sorted(want_keys)}")
    check(line["metric"] == port_bench.METRIC and line["unit"] == "solves/s",
          f"the bench line names {line['metric']} in {line['unit']}")
    check(abs(line["value"] - rates[best]) <= 0.05,    # printed to 0.1
          f"the bench's value {line['value']} is not {best}'s solves/s")
    check(line["on_path_mean_mm"] < ONPATH_GATE_MM,
          f"the bench's on-path mean {line['on_path_mean_mm']} mm")
    check(line["high_accuracy_on_path_mean_mm"] < HA_GATE_MM,
          f"the bench's high-accuracy on-path mean "
          f"{line['high_accuracy_on_path_mean_mm']} mm")
    for note in notes:
        print(f"bench [{card}]: {note}")
    print(f"bench [{card}]: python -m mppi_robotarm_tpu_torch.bench: exit 0 "
          f"in {bench_s:.1f} s, line {bench_out[-1]}")

    # ---- 25. the solve kernel at the stress shapes ---------------------
    from mppi_robotarm_tpu_torch.tools import extreme_shapes

    rng_x = np.random.default_rng(25)
    for K_x, T_x in extreme_shapes.SHAPES:
        t0 = time.perf_counter()
        row = extreme_shapes.check_shape(K_x, T_x, device, rng_x)
        print(f"stress shapes [{card}]: "
              f"{extreme_shapes.row_line(row, time.perf_counter() - t0)}")

    # ---- 26. the gate sweeps, as a smoke -------------------------------
    from mppi_robotarm_tpu_torch.tools import bench_gate_sweep, seed_sweep

    for tool, args, closing in (
            (bench_gate_sweep, ["2", "bench"],
             ("spread over 2 seeds", "suggested gate")),
            (seed_sweep, ["2", "200", "cuda"],
             ("[cuda] spread over 2 seeds", "[cuda] suggested gate"))):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(args)
        tool_name = tool.__name__.rsplit(".", 1)[1]
        swept = buf.getvalue().splitlines()
        check(rc == 0, f"{tool_name} {' '.join(args)} exited {rc}")
        check(all(any(ln.startswith(c) for ln in swept) for c in closing),
              f"{tool_name} printed no spread: {swept[-6:]}")
        for ln in swept:
            print(f"sweep [{card}]: {ln}")
        print(f"sweep [{card}]: {tool_name} {' '.join(args)}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s")

    # ---- 27. the eager backend as replayed CUDA graphs ------------------
    from mppi_robotarm_tpu_torch.tools import eager_loop

    t0 = time.perf_counter()
    counts = loop._launch_counts()
    for mod, attr in loop._COUNTERS:
        setattr(mod, attr, 0)
    for label, diffs in eager_loop.check_bits(device):
        bad = {k: v for k, v in diffs.items() if v != 0.0}
        print(f"eager [{card}]: {label}: "
              + ("bitwise on every field" if not bad else f"max |d| {bad}"))
        check(not bad, f"eager: {label}: not bitwise: {bad}")
    et = eager_loop.time_loop(device)
    eager_counts = loop._launch_counts()
    check(not any(eager_counts), "the eager path launched the port's "
          "kernels: " + ", ".join(
              f"{mod.__name__}.{attr} {v}"
              for (mod, attr), v in zip(loop._COUNTERS, eager_counts) if v))
    for (mod, attr), v in zip(loop._COUNTERS, counts):
        setattr(mod, attr, v)
    check(et["events"] > 0 and et["busy_us"] > 0,
          "the profiler saw no device event in the eager graphs")
    print(f"eager [{card}]: simulate(backend='eager') at benchmark_preset "
          f"as CUDA graphs of {et['chunk']} steps "
          f"{et['us']['graphs']:.2f} us/step (the host enqueues a step "
          f"in {et['enqueue_us']:.2f}), uncaptured "
          f"{et['us']['uncaptured']:.2f} us/step (CUDA events over "
          f"{et['steps']} steps, min of 3 in turns; runs "
          f"{ {k: [round(v, 1) for v in r] for k, r in et['runs_ms'].items()} } "
          f"ms; the host loop it replaced 65.4 ms/step, PERF.md); "
          f"{et['events']:.1f} device "
          f"events a step, device busy {et['busy_us']:.2f} us/step, idle "
          f"share {et['idle']:.3f}; capture and instantiation "
          + ", ".join(f"{n} steps {t:.3f} s"
                      for n, t in sorted(et["captures"].items()))
          + "; no launch of the port's kernels")
    ef = eager_loop.fleet_rate(device)
    check(ef["finite"], "the eager fleet's records are not finite")
    print(f"eager [{card}]: simulate_batch(backend='eager') on the fleet, "
          f"{BATCH} x K=128 T=30, {ef['steps']} steps: "
          f"{ef['rate']:,.0f} scenario-steps/s (runs "
          f"{[round(v, 1) for v in ef['runs_ms']]} ms), "
          f"{ef['events']:.1f} device events a step; phase 27 in "
          f"{time.perf_counter() - t0:.1f} s")

    check("jax" not in sys.modules,
          "the port imported JAX during phases 2-27")

    # ---- bounds, from this run's shapes (``utils/roofline.py``) ---------
    f4 = 4
    W = cfg.search_idx_len
    live_k1 = int((~rec.done).sum())       # phase 6 times phase 4's run
    k1_ops = live_k1 * rollout_ops(cfg.num_samples, cfg.horizon, W,
                                   True) / STEPS
    k1_bound = bound(
        k1_ops,
        (ref.numel() * f4 + STEPS * cuda_sim.REC_LANES * f4
         + 2 * (2 + 2 + 2 * cfg.horizon) * f4 + 3 * 8) / STEPS)
    # the solve at K=1024: the rollouts, the tile softmaxes, and the
    # combine of the 32 tile partials (the median counts at most fw*fw
    # compare pairs an output: it stops at the median's rank); its bytes
    # are the inputs and outputs alone, as the partials never need to leave
    # the chip
    n_tiles_1k = cuda_solve._plan(cfg, cfg.num_samples, None, True, True,
                                  1, sm_count)[1]
    k2_ops = solve_ops(cfg, n_tiles_1k)
    k2_bound = bound(
        k2_ops,
        (x1.numel() + u1.numel() + win1.numel() + cfg.num_samples
         + u1.numel() + 2) * f4 + 2 * 8)
    k3_ops = fleet_live * rollout_ops(cfg_b.num_samples, cfg_b.horizon,
                                      cfg_b.search_idx_len,
                                      True) / FLEET_TIME_STEPS
    k3_bound = bound(
        k3_ops,
        (ref_b.numel() * f4
         + BATCH * FLEET_TIME_STEPS * cuda_sim.REC_LANES * f4
         + BATCH * (2 * (2 + 2 + 2 * cfg_b.horizon) * f4 + 3 * 8))
        / FLEET_TIME_STEPS)
    # the step kernels at the main path's shape (B=1), a launch: the head
    # reads q, dq, the index and the rows its scan and its new window need
    # (W plus the run's mean advance a step) and writes x0, the index, the
    # flag and the window; the tail reads S, u_seq, u_prev, the state, the
    # head's index and flag and a reference row and writes u_prev, the next
    # state and the record row (float32 lanes, 8-byte ints, 1-byte flags),
    # and the head it carries reads the rows and writes the head's outputs
    # (its state is the tail's).  Operations by hand from
    # csrc/step_kernel.cu: the head 9 for fk_ee and 7 a row (two
    # differences, two squares, a sum, the scale, the compare), the tail
    # ~60 for the plant (arm_ddq, two Euler updates), 10 for fk_full, 20 a
    # sample for the statistics over S, and the carried head's
    wp_p = rec_p.wp_idx.double()
    adv = float((wp_p[1:] - wp_p[:-1]).mean())
    head_rows = ((W + adv) * 4 + 4 + W * 4) * f4 + 8 + 1
    # (the head's work weighs as the share of the run's tails that carried
    # it, as the tail's time is the mean over all of them)
    head_bound = bound(9 + 7 * W, 4 * f4 + 8 + head_rows)
    carried = carried_heads / tail_launches
    tail_bound = bound(20 * cfg.num_samples + 70 + carried * (9 + 7 * W),
                       (cfg.num_samples + 3 * 2 * cfg.horizon + 4 + 4 + 2
                        + 6 * 2 + 4) * f4 + 8 * 8 + 4 + carried * head_rows)
    # the sharded step's kernels at the main path's shape (B=1, T=50), a
    # launch: the rescale reads m, m_s, η_s and A_s (2T) and writes the
    # message (1 + 2T); a difference, a multiply and an exp, then a
    # multiply an element.  The finish reads the message and u_prev and
    # writes u_seq; a division and an add an element and at most 2 fw^2
    # compares (the count stops at the median's rank)
    scale_bound = bound(3 + 1 + 2 * T, (3 + 2 * T + 1 + 2 * T) * f4)
    finish_bound = bound(2 * T * (2 + 2 * cfg.filter_window ** 2),
                         (1 + 2 * T + 2 * T + 2 * T) * f4)
    # pathgen_kernel at phase 19's main shape (float32, PATHGEN_STEPS): it
    # reads q0 and the three (N, 2) targets and writes the (N, 6) rows
    g1_bound = bound(PATHGEN_STEPS * PATHGEN_OPS,
                     (2 + 3 * 2 * PATHGEN_STEPS + 6 * PATHGEN_STEPS) * f4)
    p1_bound = bound(xp.numel(), 2 * xp.numel() * f4)
    p2_bound = bound(xp.numel(), (2 * xp.numel() + b2.numel()) * f4)
    print(f"bounds [{card}]: sim_kernel {k1_bound[0] * 1e3:.4f} us/step "
          f"({k1_bound[1]}, {live_k1} of {STEPS} steps live), solve_kernel "
          f"{k2_bound[0] * 1e3:.4f} us ({k2_bound[1]}), fleet_kernel "
          f"{k3_bound[0] * 1e3:.4f} us/launch-step ({k3_bound[1]}, "
          f"{fleet_live} of {BATCH * FLEET_TIME_STEPS} scenario-steps "
          f"live), step_head_kernel {head_bound[0] * 1e3:.5f} us "
          f"({head_bound[1]}), step_tail_kernel carrying the next head "
          f"{tail_bound[0] * 1e3:.5f} us ({tail_bound[1]}), "
          f"probe_scale_kernel {p1_bound[0] * 1e3:.5f} us "
          f"({p1_bound[1]}), probe_big_kernel {p2_bound[0] * 1e3:.5f} us "
          f"({p2_bound[1]}), shard_scale_kernel {scale_bound[0] * 1e3:.5f} "
          f"us ({scale_bound[1]}), shard_finish_kernel "
          f"{finish_bound[0] * 1e3:.5f} us ({finish_bound[1]}), "
          f"pathgen_kernel {g1_bound[0] * 1e3:.5f} us ({g1_bound[1]})")
    issue_us = lambda ops: ops / UNFUSED_OPS * 1e6
    print(f"operations at the unfused FP32 issue rate, "
          f"{UNFUSED_OPS / 1e12:g} T/s (not bound_ms) [{card}]: sim_kernel "
          f"{issue_us(k1_ops):.4f} us/step, solve_kernel "
          f"{issue_us(k2_ops):.4f} us, fleet_kernel {issue_us(k3_ops):.4f} "
          f"us/launch-step")

    def entry(name, source, replaces, launches, err, ms, plain, bnd,
              library=None):
        return {"name": name, "route": "cuda",
                "source": "mppi_robotarm_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library}

    dev_1k, ev_1k, plain_1k = timing["K=1024 H=50"]
    print(json.dumps({"kernels": [
        entry("sim_kernel", "sim_kernel.cu",
              "mppi_robotarm_tpu/ops/pallas_sim.py:225", launches, max_err,
              kern_ms, plain_ms, k1_bound),
        entry("solve_kernel", "solve_kernel.cu",
              "mppi_robotarm_tpu/ops/pallas_rollout.py:380 and :585 (its "
              "finalize)", solve_launches, max(s_err, w_err),
              dev_1k["solve_tile_kernel"] / 1e3, plain_1k, k2_bound),
        entry("fleet_kernel", "fleet_kernel.cu",
              "mppi_robotarm_tpu/ops/pallas_sim.py:552", fleet_launches,
              fleet_err, fleet_ms, plain_fleet_ms, k3_bound),
        entry("probe_scale_kernel", "probe_kernels.cu",
              "tools/tpu_overhead.py:45", scale_launches, probe_err, p1_ms,
              p1_plain_ms, p1_bound, p1_lib_ms),
        entry("probe_big_kernel", "probe_kernels.cu",
              "tools/tpu_overhead.py:59", big_launches, probe_err, p2_ms,
              p2_plain_ms, p2_bound),
        entry("step_head_kernel", "step_kernel.cu",
              "mppi_robotarm_tpu/mppi/solver.py:215 (the waypoint advance "
              "of solve_batched_pallas, fused by XLA; no Pallas kernel)",
              head_launches, head_err, head_ms, plain_head_ms, head_bound),
        entry("step_tail_kernel", "step_kernel.cu",
              "mppi_robotarm_tpu/sim/loop.py:86 (sim_step's plant, freeze "
              "and record under simulate's scan :122-163, with the next "
              "step's waypoint advance, mppi/solver.py:215, fused by XLA; "
              "no Pallas kernel)", tail_launches, step_err, tail_ms,
              plain_tail_ms, tail_bound),
        entry("shard_scale_kernel", "shard_kernel.cu",
              "mppi_robotarm_tpu/parallel/sharded.py:139-142 (the rescale "
              "of _solve_local_pallas between its pmin and psum, fused by "
              "XLA; no Pallas kernel)", by_rank["scale"][0], s34_err,
              scale_ms, plain_scale_ms, scale_bound),
        entry("shard_finish_kernel", "shard_kernel.cu",
              "mppi_robotarm_tpu/parallel/sharded.py:143-149 (Σwε = A/η, the "
              "median filter and the u update after the psum, fused by XLA; "
              "no Pallas kernel)", by_rank["finish"][0], s34_err, finish_ms,
              plain_finish_ms, finish_bound),
        entry("pathgen_kernel", "pathgen_kernel.cu",
              "mppi_robotarm_tpu/sim/pathgen.py:55-71 (generate_circle_path's "
              "lax.scan, compiled by XLA; no Pallas kernel)", g1_launches,
              g1_err, g1_ms, g1_plain_ms, g1_bound)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
