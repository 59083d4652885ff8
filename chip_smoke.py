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
  4. the fused path, ``simulate_fused(benchmark_preset, seed 0, 4000 steps)``:
     the kernel's launch count, finite records, >= 1000 live steps, the
     on-path mean over the first 1500 live steps < 42 mm, and
     high_accuracy_preset < 18 mm;
  5. continuation: 2000 + 2000 chained steps equal one 4000-step run;
  6. timing with CUDA events: the kernel over the 4000-step run and the plain
     twin over 20 steps, at the benchmark shape;
  7. the solve kernels against their plain twin, eps and PRNG modes, at
     K=1024/H=50 (B=1), K=100/T=30 (B=8), K=65536/H=50 (B=1) and phase 9's
     fused solve at K=128/T=30 (B=4096), and raw rows with k_offset: S and
     m bit for bit, Σwε / u_new within 2e-5, η within 2e-5 relative, PRNG
     noise == the twin's bit for bit and == philox_epsilon for up to 8
     scenarios, two runs the same bits;
  8. the per-step path, ``simulate(benchmark_preset, seed 0, 4000 steps,
     backend="cuda")``: solve-kernel launches >= live steps, finite records,
     on-path mean < 42 mm, its first 8 steps == phase 4's fused run within
     the bands of phase 2;
  9. the batch, ``simulate_batch(backend="cuda")`` at 4096 scenarios x
     K=128, T=30 for 50 steps: finite records, scenario 0 == its run alone
     bit for bit;
 10. timing: the solve kernels' device time (torch.profiler) and CUDA-event
     time per solve against the plain twin at K=1024 and K=65536, the
     per-step loop's µs/step and device idle share (device-busy µs/step
     from a profiled window against the unprofiled µs/step), the batch's
     scenario-steps/s.

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
SOLVE_LAM = 3e5       # phase 7: tens of samples carry weight (at the
                      # presets' lam = 1 the softmax is one-hot)
W_TOL = 2e-5          # phase 7: Σwε / u_new absolute, η and raw rows relative
BATCH, BATCH_STEPS = 4096, 50      # BASELINE config 4 at K=128, T=30


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


def device_total(event) -> float:
    """An averaged profiler event's own device time, µs (the attribute's
    name changed across torch releases)."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0.0))


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1

    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    import mppi_robotarm_tpu_torch as m
    from mppi_robotarm_tpu_torch.ops import _build, cuda_sim, cuda_solve
    from mppi_robotarm_tpu_torch.ops.cuda_rollout import philox_epsilon

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

    # ---- 7. the solve kernels against their plain twin -----------------
    cfg_w = dataclasses.replace(cfg, lam=SOLVE_LAM)
    cfg_r = dataclasses.replace(cfg_r, lam=SOLVE_LAM)
    cfg_l = dataclasses.replace(cfg_w, num_samples=65536)
    cfg_f = dataclasses.replace(cfg_w, num_samples=128, horizon=30)
    s_err, w_err = 0.0, 0.0
    for noise in ("eps", "prng"):
        for label, c, B, fuse in (("K=1024 H=50", cfg_w, 1, True),
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
    cuda_solve.LAUNCHES = cuda_solve.COMBINE_LAUNCHES = 0
    t0 = time.perf_counter()
    final_p, rec_p = m.simulate(arm, cfg, sim, ref, state0, STEPS,
                                backend="cuda")
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    solve_launches = cuda_solve.LAUNCHES
    combine_launches = cuda_solve.COMBINE_LAUNCHES
    live = int((~rec_p.done).sum())
    print(f"per-step path: simulate(backend='cuda') {STEPS} steps, "
          f"solve_tile_kernel launches {solve_launches}, solve_combine_kernel "
          f"launches {combine_launches}, live steps {live}")
    check(solve_launches >= live and combine_launches >= live,
          "the per-step path launched fewer solves than live steps")
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
    final_b, rec_b = run_batch()
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
          f"{int((~rec_b.done[-1]).sum())} scenarios live at the end")

    # ---- 10. timing ----------------------------------------------------
    def device_us(fn, n):
        """Device time per call of each solve kernel (torch.profiler)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            name = e.key.split("(")[0]
            if name in ("solve_tile_kernel", "solve_combine_kernel"):
                out[name] = device_total(e) / n
        check(len(out) == 2, f"the profiler saw no solve kernels: {out}")
        return out

    x1 = torch.cat([state0.q, state0.dq])[None]
    u1 = state0.mppi.u_prev[None].contiguous()
    win1 = ref[:cfg.search_idx_len][None].contiguous()
    timing = {}
    for label, c in (("K=1024", cfg), ("K=65536",
                                        dataclasses.replace(cfg, num_samples=65536))):
        kw = dict(seed=torch.tensor([0], device=device),
                  step=torch.tensor([0], device=device), fuse_update=True,
                  emit_eps=False)
        call = lambda: cuda_solve.solve_batched(arm, c, x1, u1, win1, **kw)
        dev_us = device_us(call, 20)
        ev = [t / 20 for t in cuda_time(lambda: [call() for _ in range(20)], 3)]
        plain = cuda_time(lambda: cuda_solve.solve_batched_reference(
            arm, c, x1, u1, win1, **kw), 3)
        K = c.num_samples
        tile = cuda_solve.default_tile(K, c)
        w_ref = cuda_solve.solve_batched_reference(
            arm, c, x1, u1, win1, **{**kw, "emit_eps": True})
        parts = cuda_solve.tile_partials(w_ref[1], w_ref[2], tile, c.lam)
        plain_comb = cuda_time(lambda: cuda_solve.combine_reference(
            *parts, u1, c, fuse_update=True), 3)
        timing[label] = (dev_us, min(ev), min(plain), min(plain_comb))
        print(f"timing [{card}]: solve {label} H=50: solve_tile_kernel "
              f"{dev_us['solve_tile_kernel']:.2f} us + solve_combine_kernel "
              f"{dev_us['solve_combine_kernel']:.2f} us device time (tile "
              f"{tile}, {-(-K // tile)} tiles); {min(ev) * 1e3:.2f} us per "
              f"call by CUDA events over 20 calls, runs "
              f"{[round(t * 1e3, 2) for t in ev]}; plain twin "
              f"{min(plain) * 1e3:.1f} us/solve, its combine "
              f"{min(plain_comb) * 1e3:.1f} us")

    loop_steps = 1000
    lt = cuda_time(lambda: m.simulate(arm, cfg, sim, ref, state0, loop_steps,
                                      backend="cuda"), 3)
    loop_us = min(lt) / loop_steps * 1e3
    steps_w = 300
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.simulate(arm, cfg, sim, ref, state0, steps_w, backend="cuda")
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    busy_us = sum(device_total(e) for e in prof.key_averages()) / steps_w
    idle = 1.0 - busy_us / loop_us      # the profiler slows the host only
    print(f"timing [{card}]: per-step loop {loop_us:.2f} us/step by CUDA "
          f"events over {loop_steps} steps, runs {[round(t, 1) for t in lt]} "
          f"ms ({loop_wall / STEPS * 1e6:.2f} us/step by wall clock over "
          f"phase 8's {STEPS}) vs sim_kernel {kern_ms * 1e3:.2f} us/step; "
          f"device busy {busy_us:.2f} us/step in a profiled {steps_w}-step "
          f"window ({window / steps_w * 1e6:.2f} us/step under the "
          f"profiler); idle share {idle:.3f} of the unprofiled "
          f"{loop_us:.2f} us/step")
    bt = cuda_time(run_batch, 3)
    rate = BATCH * BATCH_STEPS / (min(bt) / 1e3)
    print(f"timing [{card}]: batch {BATCH} x {BATCH_STEPS} steps "
          f"{min(bt):.2f} ms (runs {[round(t, 2) for t in bt]}), "
          f"{rate:,.0f} scenario-steps/s")

    dev_1k, ev_1k, plain_1k, plain_comb_1k = timing["K=1024"]
    print(json.dumps({"kernels": [
        {"name": "sim_kernel", "route": "cuda",
         "source": "mppi_robotarm_tpu_torch/csrc/sim_kernel.cu",
         "replaces": "mppi_robotarm_tpu/ops/pallas_sim.py:225",
         "launches": launches, "max_abs_err": max_err,
         "ms": kern_ms, "plain_ms": plain_ms},
        {"name": "solve_kernel", "route": "cuda",
         "source": "mppi_robotarm_tpu_torch/csrc/solve_kernel.cu",
         "replaces": "mppi_robotarm_tpu/ops/pallas_rollout.py:380",
         "launches": solve_launches, "max_abs_err": s_err,
         "ms": dev_1k["solve_tile_kernel"] / 1e3, "plain_ms": plain_1k},
        {"name": "solve_combine_kernel", "route": "cuda",
         "source": "mppi_robotarm_tpu_torch/csrc/solve_kernel.cu",
         "replaces": "mppi_robotarm_tpu/ops/pallas_rollout.py:585",
         "launches": combine_launches, "max_abs_err": w_err,
         "ms": dev_1k["solve_combine_kernel"] / 1e3,
         "plain_ms": plain_comb_1k}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
