"""Process mesh and multi-process bring-up over ``torch.distributed``.

The counterpart of ``mppi_robotarm_tpu/parallel/mesh.py``.  One process a
rank; the ranks form a ``torch.distributed.device_mesh.DeviceMesh`` of
shape (data, samples) with the JAX package's axis names:

  * ``'data'``    — independent scenarios: no communication;
  * ``'samples'`` — the K rollout-sample axis of one scenario: the sharded
                    solve all-reduces over this axis's group.

Backend: ``nccl`` when each rank has a GPU of its own, ``gloo`` otherwise.
NCCL refuses two ranks on one GPU ("Duplicate GPU detected"), so ranks
that share a card, or run on the CPU, take gloo, whose ``all_reduce`` (MIN
and SUM, the only collectives the sharded programs make) takes CUDA
tensors as well as CPU ones.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

DATA_AXIS = "data"
SAMPLES_AXIS = "samples"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data: Optional[int] = None, samples: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'samples') DeviceMesh over the process group's ranks.

    By default every rank goes to 'data': scenario parallelism needs no
    communication.  A single process with no process group forms one of
    its own (gloo on an in-process store, no socket), so a mesh of one
    works anywhere; but when the environment names a coordinator and more
    than one process (:func:`detect_multihost_env`), it raises instead:
    the caller asked for a multi-process run and must form it first with
    :func:`initialize_multihost`.  ``device_type`` is the ranks' device,
    ``cuda`` unless the caller asks for ``cpu``.
    """
    if not dist.is_initialized():
        coord, nproc, _ = detect_multihost_env()
        if coord is not None and (nproc or 1) > 1:
            raise RuntimeError(
                f"the environment asks for {nproc} processes at {coord} but "
                f"no process group exists: call initialize_multihost() "
                f"before make_mesh()")
    n = _world()
    if data is None:
        if n % samples != 0:
            raise ValueError(f"{n} devices not divisible by samples={samples}")
        data = n // samples
    if data * samples != n:
        raise ValueError(f"mesh {data}x{samples} != {n} devices")
    resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if device_type == "cuda":
        # the rank's card before the mesh picks one: its local rank's
        # (torchrun's LOCAL_RANK, else the global rank), round robin when
        # ranks outnumber the cards
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, (data, samples),
                            mesh_dim_names=(DATA_AXIS, SAMPLES_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` of ``mesh``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` of ``mesh``."""
    return mesh.get_local_rank(axis)


# Environment variables consulted, first hit wins per field: the MPPI_*
# names configure this package alone; torchrun's own names come second.
_COORD_VARS = ("MPPI_COORDINATOR_ADDRESS",)
_NPROC_VARS = ("MPPI_NUM_PROCESSES", "WORLD_SIZE")
_PID_VARS = ("MPPI_PROCESS_ID", "RANK")


def detect_multihost_env(environ=None):
    """Read multi-process bring-up parameters from the environment.

    Returns ``(coordinator_address, num_processes, process_id)`` with None
    for any field not set.  The coordinator is ``MPPI_COORDINATOR_ADDRESS``
    or torchrun's ``MASTER_ADDR:MASTER_PORT``; the count and rank are
    ``MPPI_NUM_PROCESSES`` / ``MPPI_PROCESS_ID`` or ``WORLD_SIZE`` /
    ``RANK``.  A pure function of ``environ`` (default ``os.environ``).
    Malformed integers raise ``ValueError`` naming the variable, and so
    does a coordinator with only one of the count and the rank.
    """
    env = os.environ if environ is None else environ

    def first(names):
        for n in names:
            v = env.get(n)
            if v is not None and v != "":
                return n, v
        return None, None

    _, coord = first(_COORD_VARS)
    if coord is None:
        _, addr = first(("MASTER_ADDR",))
        _, port = first(("MASTER_PORT",))
        if addr is not None and port is None:
            raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
        if addr is not None:
            coord = f"{addr}:{port}"

    def as_int(names):
        name, v = first(names)
        if v is None:
            return None
        try:
            return int(v)
        except ValueError:
            raise ValueError(f"{name}={v!r} is not an integer")

    nproc = as_int(_NPROC_VARS)
    pid = as_int(_PID_VARS)
    if coord is not None and (nproc is None) != (pid is None):
        raise ValueError(
            "incomplete multihost environment: coordinator address is set "
            f"but only one of {_NPROC_VARS[-1]}/{_PID_VARS[-1]} — set both "
            "(or neither, for a single process)")
    return coord, nproc, pid


def backend_for(device, num_processes: int) -> str:
    """``nccl`` when each of ``num_processes`` ranks on this host has a CUDA
    device of its own, else ``gloo`` (ranks sharing a card, or the CPU)."""
    device = torch.device(device)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if device.type == "cuda" and torch.cuda.device_count() >= per_host:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         initialization_timeout: Optional[int] = None,
                         device=None) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``.

    Explicit arguments win; :func:`detect_multihost_env` fills the rest.
    A no-op when no coordinator was asked for (a single process), and when
    a process group of the requested size and rank exists already; a group
    of another size or rank raises.  The backend follows ``device``
    (None: ``cuda``, which raises without a card): :func:`backend_for`.

    Failure policy: when a coordinator address was given, explicitly or
    through the environment, the caller asked for a multi-process run, so
    any failure to form it (a missing count or rank, a dead or mistyped
    address, a timeout) raises instead of leaving the process alone, where
    it would hang later in its first collective.
    """
    env_coord, env_nproc, env_pid = detect_multihost_env()
    if coordinator_address is None:
        coordinator_address = env_coord
    if num_processes is None:
        num_processes = env_nproc
    if process_id is None:
        process_id = env_pid
    if coordinator_address is None:
        return
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        want = (num_processes, process_id)
        if any(w is not None and w != h for w, h in zip(want, have)):
            raise RuntimeError(
                f"a process group of {have[0]} processes (this one rank "
                f"{have[1]}) exists already, but {num_processes} processes "
                f"(rank {process_id}) at {coordinator_address} were asked "
                f"for")
        return
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} given without the number "
            f"of processes and this process's id")
    device = resolve_device(device)
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(
        backend_for(device, num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kwargs)
