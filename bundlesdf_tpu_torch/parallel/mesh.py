"""Process meshes and their collectives (port of ``bundlesdf_tpu/parallel/
mesh.py``).

The JAX package's scale-out axes are ``dp`` (data parallel over NOF ray
batches, LoFTR pair batches and BA residual blocks; gradients and normal
equations summed) and the hash table's rows sharded over the same devices.
There, axes live on one ``jax.sharding.Mesh`` and GSPMD inserts the
collectives.  Here a :class:`Mesh` is a process group (the default one or
a sub-group), its ranks along one named axis, and this rank's device; every
rank runs the same program on its share and calls the collectives itself.

A one-rank mesh needs no process group: its collectives return their
input, so a program written for a mesh gives the single-process numbers.

``gloo`` runs every collective used here on CUDA tensors (all_reduce with
SUM and MAX, all_gather_into_tensor, reduce_scatter_tensor; checked on an
H100 with torch 2.11), so the tensors stay on the device and no collective
goes through host memory explicitly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Mesh:
    """``ranks``: the global ranks along ``axis``, in order; ``group``: their
    process group (None = the default group, or no group for one rank);
    ``device``: this rank's device."""

    ranks: tuple
    axis: str
    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This rank's index along the axis."""
        if self.size == 1:
            return 0
        return self.ranks.index(dist.get_rank())

    def bounds(self, n: int) -> tuple[int, int]:
        """The range ``[lo, hi)`` of ``n`` elements that this rank owns in a
        sharded tensor: contiguous chunks of ``ceil(n / size)``, so that the
        chunks zero-padded to that length are the equal parts of
        :meth:`all_gather` and :meth:`reduce_scatter`; the last ones may be
        short or empty."""
        chunk = math.ceil(n / self.size)
        return min(self.rank * chunk, n), min((self.rank + 1) * chunk, n)

    def rows(self, n: int) -> slice:
        """This rank's share of a batch of ``n`` rows, as ``tensor_split``
        cuts it: the first ``n % size`` ranks take one row more, and no
        rank's share is empty while ``n >= size``."""
        q, r = divmod(n, self.size)
        lo = self.rank * q + min(self.rank, r)
        return slice(lo, lo + q + (self.rank < r))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the axis, in place (``op``: sum or max)."""
        if self.size > 1:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0, in
        axis order."""
        if self.size == 1:
            return t
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of ``t`` (dim 0 a multiple of ``size``), of
        which this rank keeps its ``1 / size`` share of rows."""
        if self.size == 1:
            return t
        out = torch.empty((t.shape[0] // self.size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        return out


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` ranks (default: the whole group).

    Unlike the JAX ``Mesh(devs[:n])``, which quietly shrinks to the
    devices there are, ``n_devices > 1`` without an initialised process
    group of at least that many ranks raises: a process cannot stand in for
    ranks that were never launched.  ``n_devices`` smaller than the group
    makes a sub-group of its first ranks (every rank must call this; the
    others get an error).  ``device``: this rank's device (default: its CUDA
    card, ``parallel.distributed.rank_device``)."""
    from .distributed import rank_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n == 1:
        return Mesh((dist.get_rank() if dist.is_initialized() else 0,), axis,
                    rank_device(device))
    if n > world:
        raise RuntimeError(
            f"a {n}-rank mesh needs a process group of at least {n} ranks; this "
            f"process has {world}.  Launch one process per rank with "
            "BSDF_COORDINATOR=host:port BSDF_NUM_PROCESSES=N BSDF_PROCESS_ID=i "
            "and call parallel.distributed.init_multihost() first")
    if n == world:
        return Mesh(tuple(range(n)), axis, rank_device(device))
    group = dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        raise RuntimeError(f"rank {dist.get_rank()} is outside the {n}-rank mesh")
    return Mesh(tuple(range(n)), axis, rank_device(device), group)


def shard(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's share of ``x`` along ``dim`` (``Mesh.rows``), on its
    device."""
    sl = mesh.rows(x.shape[dim])
    return x.narrow(dim, sl.start, sl.stop - sl.start).to(mesh.device)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` on this rank's device (every rank holds it)."""
    return x.to(mesh.device)
