"""Checkpoint / resume of the closed-loop state.

One atomic ``.npz`` per save (written to a temporary file, then renamed)
with the JAX package's fields (``mppi_robotarm_tpu/utils/checkpoint.py``):
step, q, dq, u_prev, wp_idx, key_data, key_typed, done, for a single
:class:`SimState` or a batched one.  The two packages read each other's
files:

* the port writes ``key_data`` as uint32 ``[0, seed]`` per scenario with
  ``key_typed=False`` (a raw JAX key), from which the JAX fused loop
  derives the same 31-bit seed (``key_data[-1] & 0x7FFFFFFF``);
* the port reads raw or typed JAX keys through
  :func:`~mppi_robotarm_tpu_torch.convert.seed_from_key_data`.

The noise stream is keyed by (seed, absolute step), so a resumed run
continues it bit for bit.

:func:`save_checkpoint_dist` / :func:`load_checkpoint_dist` are the
counterpart of the JAX package's orbax pair (a checkpoint directory
written by all processes together): ``torch.distributed.checkpoint``, each
rank writing its 'data' block of a batched state under keys of its block
beside the mesh's 'data' size; a restore on another 'data' size joins the
blocks and cuts the fleet anew, so it never returns part of it.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..convert import seed_from_key_data
from ..device import resolve_device
from ..mppi.solver import MPPIState
from ..sim.loop import SimState

_FIELDS = ("step", "q", "dq", "u_prev", "wp_idx", "key_data", "done")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_checkpoint(path: str, state: SimState) -> None:
    """Atomically serialise a SimState (or a scenario-batched one) to .npz."""
    seeds = np.asarray(_np(state.seed), dtype=np.uint32)
    key_data = np.stack([np.zeros_like(seeds), seeds], axis=-1)
    payload = {
        "step": _np(state.step).astype(np.int32),
        "q": _np(state.q),
        "dq": _np(state.dq),
        "u_prev": _np(state.mppi.u_prev),
        "wp_idx": _np(state.mppi.wp_idx).astype(np.int32),
        "key_data": key_data,
        "key_typed": np.asarray(False),
        "done": _np(state.done),
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, dtype=None, device=None) -> SimState:
    """Restore a SimState saved by :func:`save_checkpoint` or by the JAX
    package's, on ``device`` (default ``cuda``).  ``dtype`` casts q, dq and
    u_prev (default: as saved)."""
    with np.load(path) as z:
        missing = [f for f in _FIELDS if f not in z]
        if missing:
            raise ValueError(f"checkpoint {path} missing fields {missing}")
        z = {f: z[f] for f in _FIELDS}
    device = resolve_device(device)
    as_f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    as_i = lambda v: torch.as_tensor(v.astype(np.int64), device=device)
    batched = z["q"].ndim == 2
    key_data = z["key_data"]
    if batched:
        seed = as_i(np.asarray([seed_from_key_data(k) for k in key_data]))
    else:
        seed = seed_from_key_data(key_data)
    return SimState(
        step=as_i(z["step"]), q=as_f(z["q"]), dq=as_f(z["dq"]),
        mppi=MPPIState(u_prev=as_f(z["u_prev"]), wp_idx=as_i(z["wp_idx"])),
        seed=seed,
        done=torch.as_tensor(z["done"].astype(bool), device=device))


_DIST_NAMES = ("step", "q", "dq", "u_prev", "wp_idx", "seed", "done")
_DATA_SIZE = "data_size"      # the 'data' size of the mesh a save was cut on


def _data_axis(mesh) -> tuple:
    """(size, this rank's coordinate) of ``mesh``'s 'data' axis; (1, 0)
    without a mesh."""
    from ..parallel.mesh import DATA_AXIS, axis_rank, axis_size

    if mesh is None:
        return 1, 0
    return axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)


def _dist_state_dict(state: SimState, mesh=None) -> dict:
    """What one rank writes: its block's fields under ``data{d}.<field>``
    and the mesh's 'data' size, on the CPU."""
    size, d = _data_axis(mesh)
    fields = {"step": state.step, "q": state.q, "dq": state.dq,
              "u_prev": state.mppi.u_prev, "wp_idx": state.mppi.wp_idx,
              "seed": state.seed, "done": state.done}
    sd = {f"data{d}.{k}": torch.as_tensor(v).detach().cpu().clone()
          for k, v in fields.items()}
    sd[_DATA_SIZE] = torch.tensor(size)
    return sd


def save_checkpoint_dist(path: str, state: SimState, mesh=None) -> None:
    """Save this rank's block of a SimState into the checkpoint directory
    ``path`` through ``torch.distributed.checkpoint``, collectively with
    every rank of the process group.

    Each rank writes its block (``parallel/sharded.py::scenario_shard``) under
    keys ``data{d}.<field>`` of its 'data' coordinate d on ``mesh``, and the
    mesh's 'data' size under ``data_size``; ranks that share a block (the
    'samples' axis) hold the same tensors, which the checkpoint writes
    once.  With no ``mesh`` and no process group it is a one-process
    save."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_dist_state_dict(state, mesh), checkpoint_id=path,
             no_dist=not dist.is_initialized())


def load_checkpoint_dist(path: str, mesh=None, dtype=None,
                         device=None) -> SimState:
    """Restore this rank's block of the state saved by
    :func:`save_checkpoint_dist`, on ``device`` (default ``cuda``), bit
    for bit; ``dtype`` casts q, dq and u_prev (default: as saved).

    On a mesh of the save's 'data' size each rank reads its own block.  On
    another size (``mesh=None`` is size 1) it reads every block, joins them
    in data order into the whole fleet and cuts that by its own 'data'
    coordinate (``parallel/sharded.py::scenario_shard``), as the JAX
    package's orbax restore gives the whole state on any mesh; it raises
    where the fleet cannot be cut so (a single scenario, or a batch the
    new size does not divide).  A checkpoint without ``data_size`` counts
    its ``data{d}`` blocks."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    no_dist = not dist.is_initialized()
    if _DATA_SIZE in meta:
        got = {_DATA_SIZE: torch.empty((), dtype=torch.int64)}
        dcp.load(got, checkpoint_id=path, no_dist=no_dist)
        saved = int(got[_DATA_SIZE])
    else:
        saved = len({k.split(".", 1)[0] for k in meta if "." in k})
    size, d = _data_axis(mesh)
    blocks = [f"data{d}."] if size == saved else [
        f"data{b}." for b in range(saved)]
    missing = [b + n for b in blocks for n in _DIST_NAMES
               if b + n not in meta]
    if missing:
        raise ValueError(f"checkpoint {path} has no fields {missing} "
                         f"(this rank's block: data{d}.*)")
    sd = {b + n: torch.empty(tuple(meta[b + n].size),
                             dtype=meta[b + n].properties.dtype)
          for b in blocks for n in _DIST_NAMES}
    dcp.load(sd, checkpoint_id=path, no_dist=no_dist)
    z = {n: torch.cat([sd[b + n] for b in blocks]) if len(blocks) > 1
         else sd[blocks[0] + n] for n in _DIST_NAMES}
    if size != saved:
        if z["q"].dim() != 2:
            raise ValueError(
                f"checkpoint {path} holds one scenario, saved on a 'data' "
                f"size of {saved}: a mesh of 'data' size {size} cannot cut "
                f"it into blocks (this rank's block: data{d}.*)")
        if mesh is not None:
            from ..parallel.sharded import scenario_shard

            z = dict(zip(_DIST_NAMES, scenario_shard(
                mesh, tuple(z[n] for n in _DIST_NAMES))))
    device = resolve_device(device)
    as_f = lambda v: v.to(device=device, dtype=dtype or v.dtype)
    seed = z["seed"].to(device) if z["q"].dim() == 2 else int(z["seed"])
    return SimState(
        step=z["step"].to(device), q=as_f(z["q"]), dq=as_f(z["dq"]),
        mppi=MPPIState(u_prev=as_f(z["u_prev"]),
                       wp_idx=z["wp_idx"].to(device)),
        seed=seed, done=z["done"].to(device))
