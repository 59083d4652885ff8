"""Split a launch's fixed cost from its work on the GPU.

The counterpart of ``tools/tpu_overhead.py``: the same five chains of 100
iterations, each timed two ways on the card,

* as eager launches from the host, CUDA events around the chain, which is
  how the port's per-step loop runs today;
* as one CUDA graph of the 100 iterations, replayed, the counterpart of
  the JAX tool's jitted ``lax.scan``.

The chains:

1. the torch op ``c * 1.000001 + 1e-7`` on (8, 128) float32: two aten
   kernels, a mul and an add, where XLA fuses one;
2. P1, :func:`~..ops.cuda_probe.probe_scale` (``probe_scale_kernel``);
3. P2, :func:`~..ops.cuda_probe.probe_big`, then ``o + 1e-9 * b[0, 0, 0]``;
4. :func:`~..ops.cuda_solve.solve_core` at ``benchmark_preset``'s K=1024,
   H=50 on a W=30 window of ``synth_circle_path(2000)`` at index 0, from
   ``x0 = [1.1522, -1.2661, 0, 0]`` and the warm start, carrying
   ``(u, seed)``: ``u ← u + 1e-6·w_eps``, ``seed ← seed + 1``, with seed a
   device int64 tensor so that the graph replays no host copy;
5. the same with ``emit_eps=False``.

Run on a machine with an NVIDIA GPU (without one it exits non-zero):

    python -m mppi_robotarm_tpu_torch.tools.overhead

It prints the card's name and power limit, then one line per chain: eager
and graph µs per iteration, device launches per iteration (kernels, copies
and memsets, counted by ``torch.profiler`` over one eager chain and
rounded), and whether the graph's final carry equals the eager chain's bit
for bit.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable, List, NamedTuple, Tuple

import torch

from ..config import ArmParams, benchmark_preset
from ..ops import cuda_probe, cuda_solve
from ..ops.waypoint import slice_window
from ..sim.paths import synth_circle_path

N_ITERS = 100          # iterations of a chain, as tools/tpu_overhead.py
REPS = 5               # timed chains; the minimum is kept
X0 = (1.1522, -1.2661, 0.0, 0.0)


class ChainTiming(NamedTuple):
    eager_us: float        # µs per iteration, eager launches from the host
    graph_us: float        # µs per iteration, one replayed CUDA graph
    launches: int          # device launches per iteration (torch.profiler)
    replays: int           # graph replays made; the wrappers' launch
                           # counters count the capture once
    eager_carry: object    # final carry of the eager chain
    graph_carry: object    # final carry of the graph (a copy)


def _tree(fn, carry):
    return tuple(fn(c) for c in carry) if isinstance(carry, tuple) \
        else fn(carry)


def run_chain(fn: Callable, carry, n: int):
    """``carry = fn(carry)`` ``n`` times, eagerly, on any device."""
    for _ in range(n):
        carry = fn(carry)
    return carry


def same_bits(a, b) -> bool:
    """Two carries hold the same bits, tensor by tensor."""
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _min_event_ms(fn: Callable, reps: int) -> float:
    """The least time of ``reps`` calls of ``fn``, by CUDA events, ms."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def device_launches(fn: Callable, per: int = 1) -> int:
    """Kernels, copies and memsets that ``fn`` puts on the device, as
    ``torch.profiler`` sees them.  A window can miss events: one has been
    seen to come back with none, and one with too few for ``fn``'s ``per``
    iterations to round to a launch each.  So a window whose count rounds
    to 0 an iteration is tried again, three windows in all, and the most
    any of them saw is returned (a window never sees more than ``fn``
    launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = 0
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = max(seen, sum(e.device_type == DeviceType.CUDA
                             for e in prof.events()))
        if round(seen / per):
            break
    return seen


def time_chain(fn: Callable, carry, n: int = N_ITERS,
               reps: int = REPS) -> ChainTiming:
    """Time ``n`` iterations of ``carry = fn(carry)`` on the GPU, eagerly
    and as one captured CUDA graph; ``carry`` is a CUDA tensor or a tuple
    of them, and ``fn`` must make new tensors, not write its input.

    A first call warms up (it builds the kernels' library and allocates);
    each form is timed ``reps`` times by CUDA events and the least time is
    kept.  The graph is captured from copies of ``carry``, so its replays
    start where the eager chains do.  Raises without a CUDA device.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_chain times the GPU and there is no CUDA "
                           "device (run_chain runs a chain on any device)")
    leaves = carry if isinstance(carry, tuple) else (carry,)
    if not all(isinstance(c, torch.Tensor) and c.is_cuda for c in leaves):
        raise ValueError("the carry must be CUDA tensors")
    fn(carry)
    torch.cuda.synchronize()
    out = {}
    eager_ms = _min_event_ms(
        lambda: out.__setitem__("eager", run_chain(fn, carry, n)), reps)
    # rounded: the profiler can miss a launch at the edge of its window
    launches = round(device_launches(lambda: run_chain(fn, carry, n), n)
                     / n)
    static_in = _tree(torch.clone, carry)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = run_chain(fn, static_in, n)
    graph_ms = _min_event_ms(graph.replay, reps)
    return ChainTiming(eager_ms * 1e3 / n, graph_ms * 1e3 / n, launches,
                       reps, out["eager"], _tree(torch.clone, static_out))


def _big_step(c: torch.Tensor) -> torch.Tensor:
    o, b = cuda_probe.probe_big(c)
    return o + 1e-9 * b[0, 0, 0]


def solve_step(arm: ArmParams, cfg, x0: torch.Tensor, window: torch.Tensor,
               emit_eps: bool = True, eps=None) -> Callable:
    """The step of the solve chains: ``(u, seed) → (u + 1e-6·w_eps,
    seed + 1)`` through :func:`~..ops.cuda_solve.solve_core`, which draws
    its noise from ``seed`` in the kernel.  With ``eps`` (n, K, T, 2) the
    step reads ``eps[seed]`` instead (the injected-noise seam; seed then
    counts the iterations from 0)."""
    def step(carry):
        u, seed = carry
        noise = dict(seed=seed) if eps is None else dict(eps=eps[seed])
        w_eps, _, _ = cuda_solve.solve_core(arm, cfg, x0, u, window,
                                            emit_eps=emit_eps, **noise)
        return u + 1e-6 * w_eps, seed + 1
    return step


def chains(device) -> List[Tuple[str, Callable, object]]:
    """The five chains as (name, step, initial carry) on ``device``."""
    f32 = torch.float32
    x = torch.ones((8, 128), dtype=f32, device=device)
    arm, cfg, _ = benchmark_preset()
    ref = torch.as_tensor(synth_circle_path(2000), dtype=f32, device=device)
    window = slice_window(ref, 0, cfg.search_idx_len)[0]     # W=30
    x0 = torch.tensor(X0, dtype=f32, device=device)
    u0 = torch.tensor(cfg.warm_start, dtype=f32,
                      device=device).repeat(cfg.horizon, 1)
    seed0 = torch.zeros((), dtype=torch.int64, device=device)
    solve = f"solve_core K={cfg.num_samples} H={cfg.horizon}"
    return [
        ("torch op c * 1.000001 + 1e-7", lambda c: c * 1.000001 + 1e-7, x),
        ("P1 probe_scale", cuda_probe.probe_scale, x),
        ("P2 probe_big, o + 1e-9 * b[0, 0, 0]", _big_step, x),
        (solve, solve_step(arm, cfg, x0, window), (u0, seed0)),
        (solve + " emit_eps=False",
         solve_step(arm, cfg, x0, window, emit_eps=False), (u0, seed0)),
    ]


def measure(device, n: int = N_ITERS,
            reps: int = REPS) -> List[Tuple[str, ChainTiming]]:
    """:func:`time_chain` of each of the five chains on ``device``."""
    return [(name, time_chain(fn, carry, n, reps))
            for name, fn, carry in chains(device)]


def format_line(name: str, t: ChainTiming) -> str:
    return (f"{name:<40} eager {t.eager_us:9.2f} us/iter   graph "
            f"{t.graph_us:8.2f} us/iter   launches/iter {t.launches}   "
            f"graph == eager bitwise: "
            f"{same_bits(t.eager_carry, t.graph_carry)}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("overhead: no CUDA device; the chains time the GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}; {card()}")
    for name, t in measure(device):
        print(format_line(name, t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
