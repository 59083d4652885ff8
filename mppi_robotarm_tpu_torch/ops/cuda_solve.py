"""One MPPI solve for B scenarios: wrapper, CUDA kernel, plain twin.

``solve_batched`` rolls out K noisy control sequences per scenario, costs
them, and reduces them under the MPPI softmax.  It returns ``(w_eps | u_new
(B, T, 2), S (B, K), eps (B, K, T, 2) | None, (m, eta) each (B,))``: Σwε
(or the raw Σe·ε with ``normalize=False``, or with ``fuse_update`` the
median-filtered update ``u + median(Σwε)``), the per-sample costs, the
noise used, and the softmax's min cost and normaliser.  It is the port of
``mppi_robotarm_tpu/ops/pallas_rollout.py::pallas_solve_batched`` and its
kernel ``_solve_kernel``; ``solve_core`` is the single-scenario shim of
``pallas_solve_core``.

The path is picked by where the tensors lie: CUDA tensors launch the
hand-written kernel of ``csrc/solve_kernel.cu`` (one launch a solve: the
tiles, then the combine in one block a scenario; built by
``ops/_build.py`` and bound through ``ctypes``) or raise; CPU tensors take
:func:`solve_batched_reference`, the plain PyTorch version.  Nothing falls
back from one to the other.

Noise: with ``eps`` (B, K, T, 2) both read the caller's noise (the parity
seam); with ``seed`` (B,) scenario b draws Philox4x32-10 normals keyed
(seed[b], step[b]) with counter (k_offset[b] + k, t, 0, 0), the stream of
``philox_epsilon`` and of the fused loop, for any tile size.

The samples are cut into tiles of ``tile`` samples (the last one ragged,
never all padding).  Each tile reduces its own softmax (m_p, η_p, Σe·ε);
a combine then rescales the partials in tile order, m = min m_p,
η = Σ η_p·exp((m − m_p)/λ), the same two-level combine the sharded solve
does across devices.  ``nvalid`` is taken for the JAX signature and read by
neither version: the window is a clamped gather, which makes the row mask
a no-op (``pallas_rollout.py:201-211``).

CUDA graphs: a launch copies nothing from the host, so ``solve_batched``
and ``solve_core`` can be captured in ``torch.cuda.graph`` when every
operand (``seed``, ``step``, ``k_offset`` included) is already a tensor on
the device; a missing ``step`` is the kernel's step 0, not a copy.  Call
once on the device before capturing, which builds and loads the library
and allocates the arrival counters (:func:`_arrival_counters`).  The graph
keeps the kernel arguments as they were at capture: the parameter block by
value, the operands, outputs and the capture stream's counters by address
(or, inside :func:`counters_of`, the counters of the stream it is
replayed on).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from ..config import ArmParams, MPPIConfig
from .cuda_rollout import (
    _f32,
    chol_terms,
    philox_epsilon_batch,
    rollout_cost_trig,
)
from .cuda_sim import _ArmConsts, _arm_consts, _check_tensor, _ptr
from .filters import median_filter_reflect
from .noise import sigma_inverse

MAX_TILE = 512                # samples per block of the tile pass
MAX_THREADS = 512             # threads per block of the tile pass
LANE_CHOICES = (4, 2, 1)      # threads per sample of the tile pass
SM_THREADS = 128              # one warp per scheduler of an H100 SM
TILE_SMS = 132                # the H100 SXM's SMs, fixed for solve_tile
MAX_SCENARIOS = 65535         # the grid's y extent
SMEM_BYTES = 232448           # shared memory a block may take on Hopper
COUNTER_SLOTS = 8             # streams an allocation of counters serves

# Launches made by solve_batched; a run that must show it went through the
# kernel reads these before and after.  A launch captured in a CUDA graph
# counts once, at capture: the replays are the graph owner's to count.
LAUNCHES = 0                  # solve_tile_kernel, tiles and combine
COMBINE_LAUNCHES = 0          # separate combine launches: none since the
                              # combine runs in solve_tile_kernel's last block

# Arrival counters of the kernel's cross-tile combine, (MAX_SCENARIOS,)
# int32 zeros each, by (device index, stream handle), and each device's
# slots not yet given to a stream.
_COUNTERS: dict = {}
_FREE_COUNTERS: dict = {}
# (device index, launch stream) -> the stream whose counters its launches
# take instead of its own, while a counters_of block is open.
_COUNTERS_OF: dict = {}


class _SolveParams(ctypes.Structure):
    """Mirror of ``SolveParams`` in csrc/solve_kernel.cu, field for field."""

    _fields_ = [
        ("arm", _ArmConsts),
        ("l1c", ctypes.c_float), ("l2c", ctypes.c_float),
        ("lam", ctypes.c_float), ("gamma", ctypes.c_float),
        ("dt_c", ctypes.c_float),
        ("cost_scale", ctypes.c_float), ("dist_scale", ctypes.c_float),
        ("stage_w", ctypes.c_float * 4), ("term_w", ctypes.c_float * 4),
        ("exploit_thresh", ctypes.c_float), ("u_clamp", ctypes.c_float),
        ("l11", ctypes.c_float), ("l21", ctypes.c_float),
        ("l22", ctypes.c_float),
        ("sinv", ctypes.c_float * 4),
        ("has_clamp", ctypes.c_int),
        ("K", ctypes.c_int), ("T", ctypes.c_int), ("W", ctypes.c_int),
        ("fw", ctypes.c_int),
        ("tile", ctypes.c_int), ("n_tiles", ctypes.c_int),
        ("use_prng", ctypes.c_int),
        ("normalize", ctypes.c_int), ("fuse_update", ctypes.c_int),
        ("step_stride", ctypes.c_int),
        ("lanes", ctypes.c_int), ("group", ctypes.c_int),
    ]


def _max_tile(cfg: MPPIConfig) -> int:
    """The largest tile whose noise (2T floats a sample), window, controls,
    reductions and combine fit one block's shared memory; at most
    MAX_TILE."""
    fixed = 4 * (4 * cfg.search_idx_len + 4 * cfg.horizon + 18)
    fit = (SMEM_BYTES - fixed) // (4 * (2 * cfg.horizon + 1))
    return min(MAX_TILE, fit // 32 * 32)


def default_tile(K: int, cfg: MPPIConfig) -> int:
    """128 samples a block, grown with K so that the combine reads at most
    about 128 tile partials (measured on an H100 with the combine as a
    second launch: the tile pass runs no slower, and the serial combine at
    K=65536 drops from 40 µs at 512 tiles to 15 µs at 128, PERF.md)."""
    per_partial = -(-K // 128)
    return min(_max_tile(cfg), max(128, -(-per_partial // 32) * 32))


def solve_lanes(batch: int, num_samples: int, sm_count: int) -> int:
    """Threads per sample of the tile pass: the largest L in
    :data:`LANE_CHOICES` that keeps batch × K × L threads within one warp
    per scheduler of ``sm_count`` SMs (:data:`SM_THREADS` each), else 1.

    Each sample's rollout is a dependent chain, so while SMs sit idle the
    chain's latency sets the solve's time; L lanes split each window scan,
    the largest part of the chain, at the price of L-fold rollout work,
    which a full card pays in issue slots (PERF.md).
    """
    return next(L for L in LANE_CHOICES
                if batch * num_samples * L <= sm_count * SM_THREADS
                or L == 1)


def solve_tile(cfg: MPPIConfig, K: int) -> int:
    """Samples per block of the tile pass, from K and ``cfg`` alone.

    The tile sets the rounding of the cross-tile sums, so it depends on
    neither the batch nor the card: a scenario gives the same bits alone
    and in a batch, on the CPU and on any GPU.  Where one scenario's K
    samples at ``solve_lanes(1, K, TILE_SMS)`` lanes each would not fit one
    block of MAX_THREADS threads, tiles of SM_THREADS / lanes samples
    spread them over an H100's SMs (K=1024: 32 tiles of 32); else
    :func:`default_tile`.
    """
    lone = solve_lanes(1, K, TILE_SMS)
    if lone == 1 or K * lone <= MAX_THREADS:
        return default_tile(K, cfg)
    return min(SM_THREADS // lone, _max_tile(cfg))


def solve_layout(cfg: MPPIConfig, K: int, batch: int = 1,
                 sm_count: Optional[int] = None, tile: Optional[int] = None):
    """(tile, lanes, group) of the tile pass for ``batch`` scenarios of K
    samples.

    ``tile`` defaults to :func:`solve_tile`.  The lanes are the most in
    :data:`LANE_CHOICES` up to ``solve_lanes(batch, K, sm_count)`` (1
    without a card) that keep tile × lanes within MAX_THREADS threads a
    block.  ``group`` tiles of a scenario share a block: as many as make it
    SM_THREADS threads, within the scenario's tiles and the shared memory
    of :func:`_max_tile` samples (at B=64, K=1024 an H100 ran 2048
    one-warp blocks 1.5× slower than 512 blocks of four tiles, PERF.md).
    Lanes and group change no bit of any result.
    """
    tile = tile or solve_tile(cfg, K)
    top = 1 if sm_count is None else solve_lanes(batch, K, sm_count)
    lanes = next(L for L in LANE_CHOICES
                 if L <= top and (tile * L <= MAX_THREADS or L == 1))
    group = max(1, min(SM_THREADS // (tile * lanes), -(-K // tile),
                       _max_tile(cfg) // tile))
    return tile, lanes, group


def _plan(cfg: MPPIConfig, K: int, tile: Optional[int], normalize: bool,
          fuse_update: bool, batch: int = 1, sm_count: Optional[int] = None):
    """Validate the options; return (tile, n_tiles, lanes, group)."""
    cfg.validate()
    if fuse_update and (not normalize
                        or cfg.filter_window > 2 * cfg.horizon):
        raise ValueError("fuse_update requires normalize=True and "
                         "filter_window <= 2*horizon")
    if K < 1:
        raise ValueError(f"need at least one sample, got K={K}")
    top = _max_tile(cfg)
    if top < 32:
        raise ValueError(f"horizon {cfg.horizon} is too long for the solve "
                         f"kernel: 32 samples' noise must fit shared memory")
    tile, lanes, group = solve_layout(cfg, K, batch, sm_count, tile)
    if tile % 32 or not 32 <= tile <= top:
        raise ValueError(f"tile must be a multiple of 32 in [32, {top}] "
                         f"at horizon {cfg.horizon}, got {tile}")
    return tile, -(-K // tile), lanes, group


def _sm_count(device) -> Optional[int]:
    """The SM count of a CUDA device, None for the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sample_count(cfg, eps, k_local) -> int:
    if k_local is not None:
        return int(k_local)
    return eps.shape[1] if eps is not None else cfg.num_samples


def _int_col(v, B: int, device, name: str) -> torch.Tensor:
    """(B,) int64 on ``device`` from a tensor, sequence or scalar."""
    v = torch.as_tensor(v, device=device)
    if v.dtype.is_floating_point:
        raise TypeError(f"{name} must hold integers")
    return v.to(torch.int64).reshape(-1).expand(B)


def solve_batched_reference(arm: ArmParams, cfg: MPPIConfig, x0, u, window,
                            nvalid=None, seed=None, eps=None, step=None,
                            tile: Optional[int] = None, emit_eps: bool = True,
                            normalize: bool = True, fuse_update: bool = False,
                            k_local: Optional[int] = None, k_offset=None):
    """Plain PyTorch version of the solve kernel.

    Same arguments and results as :func:`solve_batched`, on any device:
    vectorised over scenarios and samples, a Python loop over the horizon
    (the shared trig-carry rollout) and over the tiles, whose partials it
    combines as the kernel's combine does.  Only the order of the sums
    inside a tile differs from the kernel.
    """
    if (seed is None) == (eps is None):
        raise ValueError("provide exactly one of seed= or eps=")
    K = _sample_count(cfg, eps, k_local)
    tile = _plan(cfg, K, tile, normalize, fuse_update)[0]
    B, device, f32 = x0.shape[0], x0.device, torch.float32
    koff = (torch.zeros(B, dtype=torch.int64, device=device)
            if k_offset is None else _int_col(k_offset, B, device,
                                              "k_offset"))
    if eps is None:
        step = 0 if step is None else step
        eps_used = philox_epsilon_batch(
            _int_col(seed, B, device, "seed"),
            _int_col(step, B, device, "step"), koff, K, cfg)
    else:
        eps_used = eps
    exploit = ((koff[:, None] + torch.arange(K, device=device)).to(f32)
               < _f32((1.0 - cfg.exploration) * cfg.num_samples))
    s = rollout_cost_trig(arm, cfg, x0[:, 0:1], x0[:, 1:2], x0[:, 2:3],
                          x0[:, 3:4], u, eps_used, window[:, None], exploit)

    m_p, eta_p, rows = tile_partials(s, eps_used, tile, cfg.lam)
    out, m, eta = combine_reference(m_p, eta_p, rows, u, cfg, normalize,
                                    fuse_update)
    return out, s, (eps_used if emit_eps else None), (m, eta)


def tile_partials(s: torch.Tensor, eps: torch.Tensor, tile: int, lam: float):
    """Each tile's own softmax, as the tile pass writes it: (m_p, eta_p)
    (B, n_tiles) and the rows Σe·ε (B, n_tiles, T, 2)."""
    ms, etas, rows = [], [], []
    for p0 in range(0, s.shape[1], tile):
        sl = slice(p0, p0 + tile)
        m_p = torch.amin(s[:, sl], dim=1)
        e = torch.exp(-(s[:, sl] - m_p[:, None]) / lam)
        ms.append(m_p)
        etas.append(torch.sum(e, dim=1))
        rows.append(torch.sum(e[..., None, None] * eps[:, sl], dim=1))
    return torch.stack(ms, 1), torch.stack(etas, 1), torch.stack(rows, 1)


def combine_reference(m_p, eta_p, rows, u, cfg: MPPIConfig,
                      normalize: bool = True, fuse_update: bool = False):
    """Plain version of the kernel's combine: the tile partials rescaled to
    the common min and summed in tile order from 0 (with one tile too:
    ``0 + row · 1``, so a row of -0 comes out +0), then normalised, left
    raw, or median-filtered and added to ``u``.  Returns (out (B, T, 2), m,
    eta)."""
    m = torch.amin(m_p, dim=1)
    eta = torch.zeros_like(m)
    acc = torch.zeros_like(rows[:, 0])
    for p in range(m_p.shape[1]):
        scale = torch.exp((m - m_p[:, p]) / cfg.lam)
        eta = eta + eta_p[:, p] * scale
        acc = acc + rows[:, p] * scale[:, None, None]
    if fuse_update:
        weps = acc * (1.0 / eta)[:, None, None]
        med = median_filter_reflect(weps.transpose(0, 1), cfg.filter_window)
        out = u + med.transpose(0, 1)
    elif normalize:
        out = acc / eta[:, None, None]
    else:
        out = acc
    return out, m, eta


@functools.lru_cache(maxsize=64)
def _solve_params(arm, cfg, K, tile, n_tiles, use_prng, normalize,
                  fuse_update, step_stride, lanes, group) -> _SolveParams:
    """The kernel's parameter block, cached by its arguments (the frozen
    configs hash): a closed loop builds it at its first step and passes
    the same one every step after.  Callers never modify it."""
    f4 = ctypes.c_float * 4
    l11, l21, l22 = chol_terms(cfg.sigma)
    return _SolveParams(
        arm=_arm_consts(arm), l1c=cfg.l1, l2c=cfg.l2, lam=cfg.lam,
        gamma=cfg.gamma, dt_c=cfg.delta_t, cost_scale=cfg.cost_scale,
        dist_scale=cfg.dist_scale, stage_w=f4(*cfg.stage_cost_weight),
        term_w=f4(*cfg.terminal_cost_weight),
        exploit_thresh=(1.0 - cfg.exploration) * cfg.num_samples,
        u_clamp=0.0 if cfg.u_clamp is None else cfg.u_clamp,
        l11=l11, l21=l21, l22=l22,
        sinv=f4(*sigma_inverse(cfg.sigma).reshape(4)),
        has_clamp=cfg.u_clamp is not None, K=K, T=cfg.horizon,
        W=cfg.search_idx_len, fw=cfg.filter_window, tile=tile,
        n_tiles=n_tiles, use_prng=use_prng, normalize=normalize,
        fuse_update=fuse_update, step_stride=step_stride, lanes=lanes,
        group=group)


def _arrival_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's arrival counters for launches on ``stream`` of
    ``device``: (MAX_SCENARIOS,) int32, zero between launches.

    Each (device, stream) keeps its own slot, so solves in flight on two
    streams never share a counter; the kernel's combining block puts each
    counter back to 0, so a slot is zeroed once, when its allocation of
    COUNTER_SLOTS slots is made, and never again.  A graph captures the
    capture stream's slot (or :func:`counters_of`'s) by address, and every
    replay leaves it zero.
    Slots are handed out during a capture too, but an allocation is not
    made there (it would come from the graph's pool, zeroed only when the
    graph replays), so a capture needs one uncaptured call on its device
    first."""
    key = (device.index, stream)
    if key not in _COUNTERS:
        free = _FREE_COUNTERS.setdefault(device.index, [])
        if not free:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "solve_batched allocates its counters at its first call "
                    "on a device: make one uncaptured call before capturing "
                    f"more than {COUNTER_SLOTS} streams' solves")
            free.extend(torch.zeros((COUNTER_SLOTS, MAX_SCENARIOS),
                                    dtype=torch.int32, device=device))
        _COUNTERS[key] = free.pop(0)
    return _COUNTERS[key]


@contextlib.contextmanager
def counters_of(device: torch.device, stream: int, on: int):
    """Inside the block, solves launched on stream ``on`` of ``device``
    take the arrival counters of stream ``stream`` (both handles).  A graph
    captured on a side stream ``on`` and replayed on ``stream`` then uses
    the counters that ``stream``'s own solves use, in order with them, and
    the side stream needs no slot of its own.  Make the block's first call
    uncaptured if ``stream`` may have no slot yet."""
    key = (device.index, on)
    _COUNTERS_OF[key] = stream
    try:
        yield
    finally:
        del _COUNTERS_OF[key]


def _launch(arm, cfg, x0, u, window, seed, eps, step, tile, emit_eps,
            normalize, fuse_update, k_local, k_offset):
    """Check the operands and launch csrc/solve_kernel.cu on the current
    stream.  Raises on anything the kernel does not take."""
    global LAUNCHES
    from ._build import load_library

    if (seed is None) == (eps is None):
        raise ValueError("provide exactly one of seed= or eps=")
    K = _sample_count(cfg, eps, k_local)
    device = x0.device
    B, T, W = x0.shape[0], cfg.horizon, cfg.search_idx_len
    tile, n_tiles, lanes, group = _plan(cfg, K, tile, normalize,
                                        fuse_update, B, _sm_count(device))
    f32 = torch.float32
    if not 1 <= B <= MAX_SCENARIOS:
        raise ValueError(f"need 1 to {MAX_SCENARIOS} scenarios, got {B}")
    _check_tensor("x0", x0, (B, 4), f32, device)
    _check_tensor("u", u, (B, T, 2), f32, device)
    _check_tensor("window", window, (B, W, 4), f32, device)
    use_prng = eps is None
    step_stride = 0
    if use_prng:
        seed = _int_col(seed, B, device, "seed").contiguous()
        if step is not None:       # None: the kernel keys every draw step 0
            step = torch.as_tensor(step, device=device)
            step_stride = int(step.dim() > 0 and step.numel() > 1)
            step = _int_col(step, 1 + (B - 1) * step_stride, device,
                            "step").contiguous()
    else:
        _check_tensor("eps", eps, (B, K, T, 2), f32, device)
        seed = step = None
    koff = (None if k_offset is None
            else _int_col(k_offset, B, device, "k_offset").contiguous())
    for name, v in (("seed", seed), ("step", step), ("k_offset", koff)):
        if v is not None and v.device != device:
            raise ValueError(f"{name} is on {v.device}, expected {device}")

    # one allocation for S, the tile partials (none for one tile: the
    # kernel combines it in shared memory), the output and (m, eta)
    stride = (2 * T + 2) if n_tiles > 1 else 0
    sizes = (B * K, B * n_tiles * stride, B * 2 * T, B, B)
    s_out, part, out, m, eta = torch.empty(
        sum(sizes), dtype=f32, device=device).split(sizes)
    s_out, out = s_out.view(B, K), out.view(B, T, 2)
    eps_out = (torch.empty((B, K, T, 2), dtype=f32, device=device)
               if use_prng and emit_eps else None)
    params = _solve_params(arm, cfg, K, tile, n_tiles, use_prng, normalize,
                           fuse_update, step_stride, lanes, group)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count = _arrival_counters(
            device, _COUNTERS_OF.get((device.index, stream), stream))
        if count.numel() < B:
            raise ValueError(f"the arrival counters cover {count.numel()} "
                             f"scenarios, not {B}")
        err = lib.mppi_solve_launch(
            ctypes.byref(params), B, _ptr(x0), _ptr(u), _ptr(window),
            _ptr(seed), _ptr(step), _ptr(koff), _ptr(eps), _ptr(eps_out),
            _ptr(s_out), _ptr(part if stride else None), _ptr(count),
            _ptr(out), _ptr(m), _ptr(eta), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("solve_kernel launch failed: "
                           + lib.mppi_error_string(err).decode())
    LAUNCHES += 1
    eps_used = (eps_out if use_prng else eps) if emit_eps else None
    return out, s_out, eps_used, (m, eta)


def solve_batched(arm: ArmParams, cfg: MPPIConfig,
                  x0: torch.Tensor,          # (B, 4) f32
                  u: torch.Tensor,           # (B, T, 2) f32
                  window: torch.Tensor,      # (B, W, 4) f32 clamped windows
                  nvalid=None,               # (B,) valid rows (unread)
                  seed=None,                 # (B,) int — PRNG mode
                  eps: Optional[torch.Tensor] = None,   # (B, K, T, 2)
                  step=None,                 # (B,) or () int, default 0
                  tile: Optional[int] = None,
                  emit_eps: bool = True,
                  normalize: bool = True,
                  fuse_update: bool = False,
                  k_local: Optional[int] = None,
                  k_offset=None):            # (B,) global index of sample 0
    """One solve of B scenarios (see the module docstring for the results).

    Any CUDA operand launches ``csrc/solve_kernel.cu`` (one launch) or
    raises; only when every tensor lies on the CPU does
    :func:`solve_batched_reference` run.
    ``tile`` (default :func:`solve_tile`) changes no per-sample cost and
    only the rounding of the cross-tile sums; the kernel's threads per
    sample and tiles per block (:func:`solve_layout`, from the batch and
    the card's SMs) change no bit.
    """
    kinds = {v.device.type for v in (x0, u, window, nvalid, seed, eps, step,
                                     k_offset)
             if isinstance(v, torch.Tensor)}
    if kinds == {"cpu"}:
        return solve_batched_reference(
            arm, cfg, x0, u, window, nvalid, seed=seed, eps=eps, step=step,
            tile=tile, emit_eps=emit_eps, normalize=normalize,
            fuse_update=fuse_update, k_local=k_local, k_offset=k_offset)
    if "cuda" not in kinds:
        raise ValueError(f"solve_batched runs on CUDA or CPU tensors, got "
                         f"{sorted(kinds)}")
    # any CUDA operand takes the kernel, which raises on mixed devices
    return _launch(arm, cfg, x0, u, window, seed, eps, step, tile, emit_eps,
                   normalize, fuse_update, k_local, k_offset)


def solve_core(arm: ArmParams, cfg: MPPIConfig, x0, u, window, nvalid=None,
               seed=None, eps: Optional[torch.Tensor] = None, step=None,
               tile: Optional[int] = None, emit_eps: bool = True,
               fuse_update: bool = False):
    """Single-scenario shim over :func:`solve_batched`: x0 (4,), u (T, 2),
    window (W, 4), eps (K, T, 2), seed and step scalars.  Returns (w_eps
    (T, 2) — u_new with ``fuse_update`` —, S (K,), eps (K, T, 2) | None).
    ``nvalid``, which no version reads, is not moved to the device."""
    one = lambda v: None if v is None else torch.as_tensor(
        v, device=x0.device).reshape(1)
    out, s, eps_used, _ = solve_batched(
        arm, cfg, x0[None], u[None], window[None], None,
        seed=one(seed), eps=None if eps is None else eps[None],
        step=one(step), tile=tile, emit_eps=emit_eps,
        fuse_update=fuse_update)
    return out[0], s[0], None if eps_used is None else eps_used[0]
