#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the device, its power limit, and the kernel build (nvcc's ptxas report);
  2. eps mode: the fused kernel against its plain PyTorch twin on the same
     injected noise, 8 steps, at benchmark_preset (K=1024, H=50) on the
     8000-point circle and at the reference config (K=100, H=30);
  3. PRNG mode: the same comparison with the kernel's Philox stream;
  4. the main path, ``simulate_fused(benchmark_preset, seed 0, 4000 steps)``:
     the kernel's launch count, finite records, >= 1000 live steps, the
     on-path mean over the first 1500 live steps < 42 mm, and
     high_accuracy_preset < 18 mm;
  5. continuation: 2000 + 2000 chained steps equal one 4000-step run;
  6. timing with CUDA events: the kernel over the 4000-step run and the plain
     twin over 20 steps, at the benchmark shape.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script fails.
"""

import json
import subprocess
import sys
import time

import numpy as np

STEPS = 4000          # the benchmark's chain length
CMP_STEPS = 8         # kernel-vs-twin comparison length
Q_TOL, U_TOL = 2e-6, 2e-5          # step i: q within Q_TOL·4^i, u U_TOL·4^i
STATS_RTOL = 1e-4                  # stats lanes at step 0, relative
ONPATH_GATE_MM = 42.0              # bench.py:160
HA_GATE_MM = 18.0                  # bench.py:175


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def onpath_mean_mm(ee, path_xy):
    """Mean distance to the nearest path point, in mm (bench.py:143-150)."""
    d = np.empty(len(ee))
    for i in range(0, len(ee), 256):
        d[i:i + 256] = np.linalg.norm(
            ee[i:i + 256, None, :] - path_xy[None], axis=-1).min(axis=1)
    return float(d.mean() * 1e3)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1

    import mppi_robotarm_tpu_torch as m
    from mppi_robotarm_tpu_torch.ops import _build, cuda_sim

    check("jax" not in sys.modules, "the port imported JAX")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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
    state0 = m.init_sim(cfg, sim, seed=0, device=device)
    cuda_sim.LAUNCHES = 0
    final, rec = m.simulate_fused(arm, cfg, sim, ref, state0, STEPS)
    torch.cuda.synchronize()
    launches = cuda_sim.LAUNCHES
    check(launches >= 1, "the main path launched no kernel")
    print(f"main path: simulate_fused {STEPS} steps, sim_kernel launches "
          f"{launches}")
    for field, v in zip(rec._fields, rec):
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"record {field} not finite")
    check(tuple(rec.q.shape) == (STEPS, 2), f"record shape {rec.q.shape}")
    path_xy = path_np[:, 0:2]

    def live_onpath(r):
        ee = r.ee.cpu().numpy()[~r.done.cpu().numpy()][:1500]
        check(len(ee) >= 1000, f"only {len(ee)} live steps")
        return onpath_mean_mm(ee, path_xy), len(ee)

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

    run_args = (arm, cfg, sim, ref, state0.q, state0.dq,
                state0.mppi.u_prev, state0.mppi.wp_idx, state0.seed)
    kern = cuda_time(lambda: cuda_sim.fused_sim_run(*run_args, STEPS), 3)
    kern_ms = min(kern) / STEPS
    plain_steps = 20
    plain = cuda_time(lambda: cuda_sim.fused_sim_reference(
        arm, cfg, sim, ref, state0.q[None], state0.dq[None],
        state0.mppi.u_prev[None], state0.mppi.wp_idx.reshape(1),
        torch.tensor([0]), plain_steps), 2)
    plain_ms = min(plain) / plain_steps
    print(f"timing [{card}]: sim_kernel {kern_ms * 1e3:.2f} us/step "
          f"({1e3 / kern_ms:,.0f} solves/s) over a {STEPS}-step launch, "
          f"runs {[round(t, 2) for t in kern]} ms")
    print(f"timing [{card}]: plain twin {plain_ms * 1e3:.1f} us/step over "
          f"{plain_steps} steps, runs {[round(t, 2) for t in plain]} ms")

    print(json.dumps({"kernels": [{
        "name": "sim_kernel", "route": "cuda",
        "source": "mppi_robotarm_tpu_torch/csrc/sim_kernel.cu",
        "replaces": "mppi_robotarm_tpu/ops/pallas_sim.py:225",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
