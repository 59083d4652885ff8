"""Sharded multi-scenario and sharded-sample MPPI over ``torch.distributed``.

The counterpart of ``mppi_robotarm_tpu/parallel/sharded.py``.  Where JAX
runs one ``shard_map`` program over a ('data', 'samples') mesh, here each
rank is a process that holds its block of every operand, as a
``shard_map`` body sees it, and the cross-shard terms are explicit
``all_reduce`` calls on the mesh's 'samples' group.  Nothing is gathered.

  * scenarios shard over 'data': no communication;
  * the K sample axis shards over 'samples': the softmax and Σwε become
    all-reduces.  The eager backend makes the JAX package's three per
    solve (MIN ρ, SUM η, SUM Σwε); the cuda backend runs the solve kernel
    with ``normalize=False`` on the rank's samples, then the two-level
    combine of :func:`combine_partials`: MIN on m, then one SUM on
    [η·exp((m − m_s)/λ), A·exp((m − m_s)/λ)] (η and A share a message).

The exploration split (Q9) depends on the global sample index, so a rank
of 'samples' coordinate r solves samples r·K_local .. (r + 1)·K_local − 1
(``k_offset``).  In PRNG mode the kernel draws those samples' slice of the
unsharded Philox stream keyed (seed, step): the samples a shard draws do
not depend on the mesh.  (JAX folds the shard index into a threefry key
instead; the eps mode takes such draws injected.)

``reduce=`` takes the all-reduce over the 'samples' axis; the default is
:class:`SamplesAllReduce` on the mesh's group.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import ArmParams, MPPIConfig, SimConfig
from ..models.arm import fk_ee
from ..mppi.solver import _median_update, shift_warm_start
from ..ops import cuda_solve
from ..ops.cuda_rollout import philox_epsilon_batch
from ..ops.noise import sigma_inverse
from ..ops.rollout import rollout_costs
from ..ops.waypoint import update_waypoint_index
from ..ops.weights import local_exp_terms
from ..sim.loop import auto_group, plant_step, simulate_fused_batch
from .mesh import DATA_AXIS, SAMPLES_AXIS, axis_rank, axis_size

Reduce = Callable[[torch.Tensor, str], torch.Tensor]
_OPS = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}


class SamplesAllReduce:
    """``all_reduce`` in place over this rank's 'samples' group, as
    ``reduce(tensor, "min" | "sum")``; returns the tensor.

    ``elide=True`` leaves every tensor as it is: each shard then normalises
    over its own samples only, semantically wrong, the JAX package's
    ``elide_collectives`` twin for costing the collectives by A/B.
    ``timed=True`` adds the host seconds of each call to ``seconds``,
    synchronising the device before and after it (a gloo all-reduce of a
    CUDA tensor copies it to the host, which waits for the device anyway).
    """

    def __init__(self, mesh, elide: bool = False, timed: bool = False):
        self.group = None if elide else mesh.get_group(SAMPLES_AXIS)
        self.timed = timed
        self.calls = 0
        self.seconds = 0.0

    def __call__(self, t: torch.Tensor, op: str) -> torch.Tensor:
        self.calls += 1
        if self.group is None:
            return t
        sync = (lambda: torch.cuda.synchronize(t.device)) \
            if self.timed and t.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        sync()
        if self.timed:
            self.seconds += time.perf_counter() - t0
        return t


def combine_partials(m_loc, eta_loc, a_loc, lam: float, reduce: Reduce):
    """The two-level online-softmax combine across sample shards: each
    shard's (min cost m_s, η_s, raw Σe·ε A_s) rescaled to the common min,
        m = MIN m_s,  η = SUM η_s·exp((m − m_s)/λ),  A = SUM A_s·exp(...).
    m_loc, eta_loc (..., B), a_loc (..., B, T, 2).  Returns (m, η, A)."""
    m = reduce(m_loc.clone(), "min")
    scale = torch.exp((m - m_loc) / lam)
    packed = torch.cat([(eta_loc * scale)[..., None],
                        (a_loc * scale[..., None, None]).flatten(-2)], dim=-1)
    packed = reduce(packed.contiguous(), "sum")
    return m, packed[..., 0], packed[..., 1:].unflatten(-1, a_loc.shape[-2:])


def _waypoints(cfg: MPPIConfig, ref_path, observed, wp_idx):
    x_obs, y_obs = fk_ee(observed[:, 0], observed[:, 1], cfg.l1, cfg.l2)
    wp_new, window, valid = update_waypoint_index(
        ref_path, wp_idx, x_obs, y_obs, cfg.search_idx_len, cfg.dist_scale)
    return wp_new, window, valid, wp_new >= ref_path.shape[0] - 1


def _finish(cfg, u_prev, w_eps, wp_new, path_end, s_local, w_local):
    u_seq = _median_update(u_prev, w_eps, cfg)
    # the reference applies the SHIFTED first element (control.py:148-152)
    u_next = shift_warm_start(u_seq)
    return u_next[:, 0], u_seq, u_next, wp_new, path_end, s_local, w_local


def _solve_eager(arm: ArmParams, cfg: MPPIConfig, ref_path, observed, u_prev,
                 wp_idx, eps, k_offset: int, reduce: Reduce):
    """The eager block solve (``_solve_local``, vectorised over the block's
    scenarios): three all-reduces a solve, each over the whole block."""
    dtype = u_prev.dtype
    wp_new, window, valid, path_end = _waypoints(cfg, ref_path, observed,
                                                 wp_idx)
    sigma_inv = torch.as_tensor(sigma_inverse(cfg.sigma), dtype=dtype,
                                device=u_prev.device)
    eps = eps.to(dtype)
    s_local = torch.stack([
        rollout_costs(arm, cfg, observed[b], u_prev[b], eps[b],
                      window[b].to(dtype), valid[b], sigma_inv,
                      k_offset=k_offset)[0]
        for b in range(observed.shape[0])])
    rho = reduce(torch.amin(s_local, dim=-1), "min")
    e, eta_local = local_exp_terms(s_local, rho[:, None], cfg.lam)
    eta = reduce(eta_local[:, 0].contiguous(), "sum")
    w_local = e / eta[:, None]
    w_eps = reduce(torch.einsum("bk,bktu->btu", w_local, eps), "sum")
    return _finish(cfg, u_prev, w_eps, wp_new, path_end, s_local, w_local)


def _solve_cuda(arm: ArmParams, cfg: MPPIConfig, ref_path, observed, u_prev,
                wp_idx, k_offset: int, reduce: Reduce, eps=None, seeds=None,
                step=None, k_local: Optional[int] = None):
    """The kernel block solve (``_solve_local_pallas``): one launch of
    ``ops/cuda_solve.py::solve_batched`` on the rank's samples, raw Σe·ε
    and (m, η) out, then :func:`combine_partials`."""
    f32, dtype = torch.float32, u_prev.dtype
    wp_new, window, _, path_end = _waypoints(cfg, ref_path, observed, wp_idx)
    B, device = observed.shape[0], observed.device
    koff = torch.full((B,), k_offset, dtype=torch.int64, device=device)
    a_local, s_local, _, (m_loc, eta_loc) = cuda_solve.solve_batched(
        arm, cfg, observed.to(f32).contiguous(), u_prev.to(f32).contiguous(),
        window.to(f32).contiguous(), seed=seeds,
        eps=None if eps is None else eps.to(f32).contiguous(), step=step,
        emit_eps=False, normalize=False, fuse_update=False, k_local=k_local,
        k_offset=koff)
    m, eta, a = combine_partials(m_loc, eta_loc, a_local, cfg.lam, reduce)
    w_local = (torch.exp(-(s_local - m[:, None]) / cfg.lam)
               / eta[:, None]).to(dtype)
    return _finish(cfg, u_prev, (a / eta[:, None, None]).to(dtype), wp_new,
                   path_end, s_local.to(dtype), w_local)


def _check_samples_divisible(cfg: MPPIConfig, mesh) -> None:
    """K must divide evenly over the 'samples' axis: a silent floor
    division would drop samples and change the solver's semantics."""
    n = axis_size(mesh, SAMPLES_AXIS)
    if cfg.num_samples % n:
        raise ValueError(
            f"num_samples={cfg.num_samples} is not divisible by the "
            f"'{SAMPLES_AXIS}' mesh axis size {n}; choose K as a multiple "
            f"of the samples-axis size (dropped samples would silently "
            f"change the softmax/weighted-noise semantics)")


def _shard_samples(cfg: MPPIConfig, mesh):
    """(K_local, k_offset) of this rank's samples."""
    _check_samples_divisible(cfg, mesh)
    k_local = cfg.num_samples // axis_size(mesh, SAMPLES_AXIS)
    return k_local, axis_rank(mesh, SAMPLES_AXIS) * k_local


def _check_backend(backend: str) -> None:
    if backend not in ("eager", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")


def make_sharded_solve(arm: ArmParams, cfg: MPPIConfig, mesh,
                       backend: str = "eager",
                       elide_collectives: bool = False,
                       reduce: Optional[Reduce] = None):
    """A sharded solve of this rank's block of scenarios and samples.

    Signature of the returned function (every operand the rank's block):
        f(ref_path (N, 4),
          observed (B_local, 4), u_prev (B_local, T, 2), wp_idx (B_local,),
          eps (B_local, K_local, T, 2))
        -> (u0 (B_local, 2), u_seq (B_local, T, 2), u_prev_next, wp_idx,
            path_end (B_local,), S (B_local, K_local), w (B_local, K_local))

    ``backend="cuda"`` solves through the solve kernel in float32 (its
    plain twin on CPU tensors) with the two-level combine;
    ``elide_collectives`` builds the collective-free measurement twin.
    """
    _check_backend(backend)
    k_local, k_offset = _shard_samples(cfg, mesh)
    reduce = reduce or SamplesAllReduce(mesh, elide=elide_collectives)

    def solve(ref_path, observed, u_prev, wp_idx, eps):
        if eps.shape[1] != k_local:
            raise ValueError(f"eps holds {eps.shape[1]} samples a scenario, "
                             f"this shard solves {k_local}")
        if backend == "cuda":
            return _solve_cuda(arm, cfg, ref_path, observed, u_prev, wp_idx,
                               k_offset, reduce, eps=eps)
        return _solve_eager(arm, cfg, ref_path, observed, u_prev, wp_idx,
                            eps, k_offset, reduce)

    return solve


def make_sharded_sim_step(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                          mesh, backend: str = "eager", noise: str = "prng",
                          reduce: Optional[Reduce] = None):
    """One sharded closed-loop step of this rank's block: solve, plant,
    freeze at the path end.

    Returns ``f(ref_path, q (B_local, 2), dq, u_prev (B_local, T, 2),
    wp_idx (B_local,), seeds=None, step=None, eps=None) -> (q', dq',
    u_prev', wp_idx', done (B_local,), u0 (B_local, 2))``.  ``noise``:
      * 'prng' — ``seeds`` (B_local,) and the absolute ``step`` (B_local,)
        key the Philox stream; the shard draws its samples' slice of the
        unsharded stream (in the kernel on the cuda backend, with
        ``philox_epsilon_batch`` on the eager one), so both backends and
        every mesh see the same noise;
      * 'eps' — ``eps`` (B_local, K_local, T, 2) injected.
    """
    _check_backend(backend)
    if noise not in ("prng", "eps"):
        raise ValueError(f"unknown noise mode {noise!r}")
    k_local, k_offset = _shard_samples(cfg, mesh)
    reduce = reduce or SamplesAllReduce(mesh)

    def step_fn(ref_path, q, dq, u_prev, wp_idx, seeds=None, step=None,
                eps=None):
        if (noise == "eps") != (eps is not None) or (
                noise == "prng" and (seeds is None or step is None)):
            raise ValueError("noise='prng' takes seeds= and step=, "
                             "noise='eps' takes eps=")
        observed = torch.cat([q, dq], dim=-1)
        B, device = q.shape[0], q.device
        if noise == "prng":
            col = lambda v: torch.as_tensor(
                v, dtype=torch.int64, device=device).reshape(-1).expand(B)
            seeds, step = col(seeds), col(step)
        if backend == "cuda":
            out = _solve_cuda(arm, cfg, ref_path, observed, u_prev, wp_idx,
                              k_offset, reduce, eps=eps, seeds=seeds,
                              step=step, k_local=k_local)
        else:
            if eps is None:
                eps = philox_epsilon_batch(
                    seeds, step, torch.full((B,), k_offset, device=device),
                    k_local, cfg)
            out = _solve_eager(arm, cfg, ref_path, observed, u_prev, wp_idx,
                               eps, k_offset, reduce)
        u0, _, u_next, wp_new, path_end, _, _ = out
        u0 = u0.to(q.dtype)
        q_new, dq_new = plant_step(arm, sim, q, dq, u0)
        keep = lambda new, old: torch.where(
            path_end.view(-1, *(1,) * (new.dim() - 1)), old, new)
        return (keep(q_new, q), keep(dq_new, dq),
                keep(u_next.to(u_prev.dtype), u_prev),
                torch.where(path_end, wp_idx, wp_new), path_end, u0)

    return step_fn


def make_sharded_fleet(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                       mesh, n_steps: int, group: Optional[int] = None):
    """Each 'data' rank runs its block of scenarios' WHOLE loops through
    ``sim/loop.py::simulate_fused_batch``: the fleet kernel at K <= 128
    (``group`` scenarios a block, default the JAX package's choice for the
    block, :func:`~..sim.loop.auto_group`), the fused kernel otherwise.  No
    collectives: a fleet has no cross-scenario term.  Runs longer than a
    launch's budget are chained there, bitwise one launch.

    Returns ``f(ref_path, states, eps_per_step=None) -> (final SimState,
    SimRecord)`` for the rank's block ``states`` (:func:`scenario_shard` of
    an ``init_sim_batch`` state); ``eps_per_step`` (B_local, n_steps, K, T,
    2) as ``simulate_fused_batch`` takes it.
    """
    def run(ref_path, states, eps_per_step=None):
        g = group or auto_group(cfg, states.q.shape[0])
        return simulate_fused_batch(arm, cfg, sim, ref_path, states,
                                    n_steps, eps_per_step=eps_per_step,
                                    group=g)

    return run


def scenario_shard(mesh, x):
    """This rank's block of ``x`` along dim 0, by its 'data' coordinate:
    a tensor, or a (named) tuple of them such as a batched ``SimState``
    (other leaves pass through).  The counterpart of JAX's
    ``scenario_sharding``, which places dim 0 on 'data'."""
    n, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)

    def cut(v):
        if isinstance(v, tuple):
            parts = [cut(f) for f in v]
            return type(v)(*parts) if hasattr(v, "_fields") else tuple(parts)
        if not isinstance(v, torch.Tensor):
            return v
        if v.shape[0] % n:
            raise ValueError(f"B={v.shape[0]} is not divisible by the "
                             f"'{DATA_AXIS}' axis size {n}")
        b = v.shape[0] // n
        return v[r * b:(r + 1) * b]

    return cut(x)
