"""Multi-process runtime entry (port of ``bundlesdf_tpu/parallel/
distributed.py``).

The JAX package runs its parallel layer either as one controller over a
device ``Mesh`` or as one process per host over a global mesh.  PyTorch's
idiom is one process per rank, every process running the same program: the
JAX multi-host model.  This module is the one place process bootstrap
lives:

  * :func:`init_multihost` joins ``torch.distributed``'s default process
    group over ``tcp://`` with the JAX module's ``BSDF_*`` environment
    fallbacks, and returns False on the single-process path;
  * :func:`global_mesh` is a 1-D mesh over every rank;
  * :func:`host_by_device_mesh` is the 2-D (hosts x local ranks) layout,
    with a process group for each row and each column.

A host is ``rank // local_world_size``; ``local_world_size`` comes from
``BSDF_LOCAL_WORLD_SIZE`` (or a launcher's ``LOCAL_WORLD_SIZE``) and is the
world size when neither is set.  A rank's device is
``cuda:(local_rank % device_count)``, or the first of ``local_device_ids``.
NCCL refuses two ranks on one device, so the default backend is ``nccl``
only when each rank of a host has a card of its own, ``gloo`` otherwise,
and always ``gloo`` on the CPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, make_mesh

# this process's layout, set by init_multihost
_LOCAL = {"local_world": 1, "device_ids": None}


def _env_int(name: str):
    return int(os.environ[name]) if name in os.environ else None


def local_world_size() -> int:
    """Ranks per host."""
    return _LOCAL["local_world"]


def rank_device_index(rank: int) -> int:
    """The CUDA device index of ``rank`` on its host:
    ``local_device_ids[0]`` when given, else ``local_rank % device_count``."""
    ids = _LOCAL["device_ids"]
    if ids:
        return int(ids[0])
    return (rank % local_world_size()) % max(torch.cuda.device_count(), 1)


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given (``"cpu"`` runs the
    plain path), else its CUDA card (raises without one)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", rank_device_index(
        dist.get_rank() if dist.is_initialized() else 0))


def default_backend(local_world: int) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   local_device_ids: list[int] | None = None,
                   backend: str | None = None) -> bool:
    """Join (or skip joining) a multi-process group.

    Arguments default from ``BSDF_COORDINATOR`` (``host:port``),
    ``BSDF_NUM_PROCESSES`` and ``BSDF_PROCESS_ID``.  Returns True when a
    process group was initialised (or already was), False on the
    single-process path (no coordinator and num_processes absent or 1).
    ``local_device_ids``: the CUDA device of this rank (its first entry).
    ``backend``: ``nccl`` or ``gloo``; default :func:`default_backend`.
    Prints the chosen backend."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("BSDF_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("BSDF_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("BSDF_PROCESS_ID")
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_multihost needs a coordinator address, the number of "
            "processes and this process's id (BSDF_COORDINATOR, "
            "BSDF_NUM_PROCESSES, BSDF_PROCESS_ID)")
    local_world = (_env_int("BSDF_LOCAL_WORLD_SIZE") or _env_int("LOCAL_WORLD_SIZE")
                   or num_processes)
    if num_processes % local_world:
        raise ValueError(f"{num_processes} processes do not split into hosts of "
                         f"{local_world}")
    backend = backend or default_backend(local_world)
    _LOCAL.update(local_world=local_world,
                  device_ids=list(local_device_ids) if local_device_ids else None)
    if backend == "nccl":
        torch.cuda.set_device(rank_device_index(process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    print(f"multihost: process {process_id}/{num_processes}, host "
          f"{process_id // local_world}, backend {backend}", flush=True)
    return True


def global_mesh(axis: str = "dp", device=None) -> Mesh:
    """A 1-D mesh over every rank of the default group (one rank without
    a group)."""
    return make_mesh(None, axis, device)


@dataclass(frozen=True)
class HostMesh:
    """The (hosts, local ranks) layout: ``grid[h, l]`` is the global rank of
    local rank ``l`` on host ``h``; ``axes[name]`` is this rank's 1-D mesh
    along that axis (its host's row for the device axis, its column for
    the host axis)."""

    grid: np.ndarray
    axis_names: tuple
    axes: dict

    def __getitem__(self, axis: str) -> Mesh:
        return self.axes[axis]


def host_by_device_mesh(host_axis: str = "host", dev_axis: str = "dp",
                        device=None) -> HostMesh:
    """The 2-D (hosts, local ranks) mesh.  Rows group each host's ranks
    contiguously (rank order), so ``dev_axis`` collectives stay inside a
    host and only ``host_axis`` crosses hosts.  Every rank creates every
    row's and column's group, in the same order (``new_group`` is
    collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per = local_world_size() if dist.is_initialized() else 1
    grid = np.arange(world).reshape(world // per, per)
    dev = rank_device(device)
    me = dist.get_rank() if dist.is_initialized() else 0
    h, loc = divmod(me, per)
    axes = {}
    for name, lines, mine in ((dev_axis, list(grid), h), (host_axis, list(grid.T), loc)):
        groups = [dist.new_group([int(r) for r in line]) if world > 1 else None
                  for line in lines]
        axes[name] = Mesh(tuple(int(r) for r in lines[mine]), name, dev, groups[mine])
    return HostMesh(grid, (host_axis, dev_axis), axes)
