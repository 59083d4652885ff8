"""The solve kernel at stress shapes: huge K, long horizons.

The counterpart of ``tools/tpu_extreme_shapes.py``.  At each of its five
(K, T) shapes (:data:`SHAPES`) it runs one ``solve(backend="cuda")`` of
``MPPIConfig()`` at that K and T from x0 = (1.1522, -1.2661, 0, 0) and the
warm start on ``synth_circle_path(2000)``, Philox seed 1, and prints the
launch layout that ``cuda_solve._plan`` picks (tile, tiles, lanes, tiles a
block) with the shared memory it takes (``cuda_solve.solve_smem_bytes``),
checks the controls finite and the solve one launch of
``csrc/solve_kernel.cu``.  Beyond the JAX tool, which checks finiteness
alone, it holds the kernel to its plain version (``cuda_solve.
solve_batched_reference``) on the card on the same inputs at lam = 3e5
(tens of samples carry weight), injected ε and the Philox stream: S and
m bit for bit, u_new within 2e-5, η within 2e-5 relative, the Philox noise
bit for bit; then it times the solve kernel by the profiler beside its
bound (``utils/roofline.py::solve_bound``).

    python -m mppi_robotarm_tpu_torch.tools.extreme_shapes

It needs an NVIDIA GPU and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..config import ArmParams, MPPIConfig
from ..mppi.solver import MPPIState, solve, step_solve_plan
from ..ops import cuda_solve, cuda_step
from ..sim.paths import synth_circle_path
from ..utils.roofline import solve_bound
from .fused_timing import kernel_device_us
from .overhead import card

SHAPES = (
    (65536, 50),      # BASELINE config 3
    (65536, 200),     # long horizon
    (8192, 500),      # a very long horizon: the smallest tile
    (131072, 100),    # 128k samples
    (1024, 30),       # next to the reference's config
)
X0 = (1.1522, -1.2661, 0.0, 0.0)
SEED = 1
PATH_POINTS = 2000
SOLVE_LAM = 3e5       # the plain-version check: tens of samples carry weight
W_TOL = 2e-5          # u_new absolute, η relative (chip_smoke phase 7)
PROFILE_CALLS = 5     # solves a profiled window


def shape_config(K: int, T: int) -> MPPIConfig:
    """``MPPIConfig()`` at K samples and horizon T, as the JAX tool's."""
    return dataclasses.replace(MPPIConfig(), num_samples=K, horizon=T)


def inputs(cfg: MPPIConfig, device):
    """(path (N, 4) float32 tensor, x0 (4,), the solver state: the warm
    start at waypoint 0) of a shape's solve on ``device``."""
    ref = torch.as_tensor(synth_circle_path(PATH_POINTS), device=device)
    x0 = torch.tensor(X0, dtype=torch.float32, device=device)
    state = MPPIState(
        u_prev=torch.tensor(cfg.warm_start, device=device).repeat(
            cfg.horizon, 1),
        wp_idx=torch.tensor(0, device=device))
    return ref, x0, state


def layout(cfg: MPPIConfig, device) -> dict:
    """The tile pass's layout for the cuda backend's solve of one scenario
    on ``device`` and the shared memory it takes."""
    tile, tiles, lanes, group = step_solve_plan(cfg, 1, device)
    return {"tile": tile, "tiles": tiles, "lanes": lanes, "group": group,
            "smem_bytes": cuda_solve.solve_smem_bytes(cfg, tile, tiles,
                                                      group)}


def solve_once(arm, cfg, ref, x0, state):
    """One ``solve(backend="cuda")`` at Philox seed SEED; returns (the
    solve-kernel launches it made, its controls finite)."""
    before = cuda_solve.LAUNCHES
    res = solve(arm, cfg, ref, x0, state, backend="cuda", seed=SEED)
    return (cuda_solve.LAUNCHES - before,
            bool(torch.isfinite(res.u_seq).all()))


def hold_to_plain(arm, cfg, ref, x0, state, noise: str, rng) -> dict:
    """The solve kernel against its plain version on the solve's own
    inputs (x0, the warm start, the step head's window) at lam =
    SOLVE_LAM, with N(0, 20·I) noise from ``rng`` (``noise="eps"``) or the
    Philox stream at (SEED, 0).  Raises ``AssertionError`` naming what
    differs; returns the largest differences."""
    c = dataclasses.replace(cfg, lam=SOLVE_LAM)
    K, T = c.num_samples, c.horizon
    device = x0.device
    window = cuda_step.step_head(c, ref, x0[None, 0:2], x0[None, 2:4],
                                 state.wp_idx.reshape(1))[3]
    kw = dict(fuse_update=c.filter_window <= 2 * T)
    if noise == "eps":
        kw["eps"] = torch.as_tensor(
            (rng.normal(size=(1, K, T, 2)) * np.sqrt(20.0)).astype(
                np.float32), device=device)
    else:
        kw.update(seed=torch.tensor([SEED], device=device),
                  step=torch.tensor([0], device=device))
    args = (arm, c, x0[None], state.u_prev[None].contiguous(), window)
    (w_k, s_k, e_k, (m_k, eta_k)) = cuda_solve.solve_batched(*args, **kw)
    (w_p, s_p, e_p, (m_p, eta_p)) = cuda_solve.solve_batched_reference(
        *args, **kw)
    label = f"K={K} T={T} {noise}"
    if not (torch.equal(s_k, s_p) and torch.equal(m_k, m_p)):
        raise AssertionError(f"{label}: S or m differs from the plain "
                             f"version")
    dw = float((w_k - w_p).abs().max())
    deta = float(((eta_k - eta_p).abs() / eta_p).max())
    if not (dw <= W_TOL and deta <= W_TOL):
        raise AssertionError(f"{label}: u_new off by {dw}, η by {deta} "
                             f"relative (bands {W_TOL})")
    if noise == "prng" and not torch.equal(e_k, e_p):
        raise AssertionError(f"{label}: the Philox noise differs")
    return {"du": dw, "deta": deta}


def device_us(arm, cfg, ref, x0, state) -> float:
    """The solve kernel's device µs a solve (torch.profiler, PROFILE_CALLS
    solves)."""
    return sum(kernel_device_us(
        lambda: solve(arm, cfg, ref, x0, state, backend="cuda", seed=SEED),
        PROFILE_CALLS, "solve_").values())


def check_shape(K: int, T: int, device, rng) -> dict:
    """A shape's whole check on ``device``: layout, one solve (finite, one
    launch), the plain-version holds in both noise modes and the device
    time beside the bound.  Raises ``AssertionError`` on a failed check."""
    arm = ArmParams()
    cfg = shape_config(K, T)
    ref, x0, state = inputs(cfg, device)
    row = {"K": K, "T": T, **layout(cfg, device)}
    if row["smem_bytes"] > cuda_solve.SMEM_BYTES:
        raise AssertionError(f"K={K} T={T}: the layout takes "
                             f"{row['smem_bytes']} bytes of shared memory")
    launches, finite = solve_once(arm, cfg, ref, x0, state)
    if not finite or launches != 1:
        raise AssertionError(f"K={K} T={T}: finite={finite}, {launches} "
                             f"solve-kernel launches for one solve")
    row.update(finite=finite, launches=launches)
    for noise in ("eps", "prng"):
        row[noise] = hold_to_plain(arm, cfg, ref, x0, state, noise, rng)
    row["device_us"] = device_us(arm, cfg, ref, x0, state)
    row["bound_ms"], row["bound_by"] = solve_bound(cfg, row["tiles"])
    return row


def row_line(row: dict, seconds: float) -> str:
    return (f"K={row['K']:7d} T={row['T']:4d} tile={row['tile']:4d} "
            f"tiles={row['tiles']:4d} lanes={row['lanes']} "
            f"group={row['group']} smem={row['smem_bytes']} B: "
            f"finite={row['finite']} launches={row['launches']}; eps: S, m "
            f"bitwise, max|du_new| {row['eps']['du']:.3g}, max rel dη "
            f"{row['eps']['deta']:.3g}; prng: S, m, noise bitwise, "
            f"max|du_new| {row['prng']['du']:.3g}, max rel dη "
            f"{row['prng']['deta']:.3g}; solve kernel "
            f"{row['device_us']:.1f} us (bound "
            f"{row['bound_ms'] * 1e3:.2f} us, {row['bound_by']}) "
            f"({seconds:.1f} s)")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("extreme_shapes: no CUDA device; the solve kernel needs one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}; {card()}")
    rng = np.random.default_rng(0)
    for K, T in SHAPES:
        t0 = time.perf_counter()
        row = check_shape(K, T, device, rng)
        print(row_line(row, time.perf_counter() - t0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
