"""Data-parallel and table-sharded NOF training (port of
``bundlesdf_tpu/parallel/nof_shard.py``).

The multi-rank version of ``nof/runner.make_train_step``: every rank draws
the whole step's batch indices and sampling jitter (the same generator
state or the same given draws on every rank), takes its share of the rays
(``Mesh.rows``), and differentiates its part of the global objective
(``runner.make_loss_fn(st, mesh)``).  ``NofOptimizer.step`` sums the
gradients over the mesh, takes the inf-norm clip over the whole, and steps
Adam; with ``shard_table`` each rank owns a range of the flat table and
its moments, and the ranges are all-gathered into the table after the
update.  As in JAX there is no microbatching in this step.

The JAX package turns its Pallas kernels off under dp (``resolve_reduce``
forces ``conv``, ``resolve_scatter`` turns ``pallas`` into ``xla``): the
Pallas custom call cannot be GSPMD-partitioned.  That is a TPU compiler
limit, not a change in what is computed.  Here each rank runs its own
program on its own rays, and the table cotangent is linear in the cache
gradient, so each rank keeps the hand-written reduce (and, under
``hash_scatter: pallas``, the fused scatter) and the sums over ranks add
up to the same table gradient.  Under ``hash_scatter: seg`` each rank's
run-cap choice reads its own rays (JAX's reads the whole batch): either
branch gives the same sums, in another order.
"""
from __future__ import annotations

import torch

from ..nof import render as nof_render
from ..nof import runner as nof_runner
from .mesh import Mesh


def reduce_metrics(metrics: dict, mesh: Mesh) -> dict:
    """Sum every rank's metrics over the mesh in one collective (f64, so
    the ray count stays exact): the loss parts add up to the global loss on
    every rank."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
    flat = mesh.all_reduce(flat)
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def make_dp_train_step(st: nof_runner.TrainStatics, optimizer: nof_runner.NofOptimizer,
                       mesh: Mesh, shard_table: bool = True):
    """The data-parallel step over ``mesh``.  Returns ``(step, place)``.

    ``step(params, step, rays, n_rays, grid, c2w, batch_idx=None,
    draws=None, generator=None) -> metrics`` has ``make_train_step``'s
    signature: ``batch_idx`` (n_rand,) and ``draws`` are the whole batch's
    (drawn from ``generator`` on every rank when absent), and the metrics
    are summed over the mesh.  ``params`` are updated in place, identical
    on every rank.  ``place(params, rays, grid, c2w)`` puts the inputs on
    this rank's device (the parameters must already be there: the
    optimizer holds them).  ``optimizer`` is distributed over ``mesh``
    here."""
    loss_fn = nof_runner.make_loss_fn(st, mesh)
    optimizer.distribute(mesh, shard_table)

    def place(params, rays, grid, c2w):
        for p in nof_runner.param_leaves(params):
            if p.device != mesh.device:
                raise ValueError(f"parameters on {p.device}, the mesh's rank on "
                                 f"{mesh.device}: build them on the rank's device")
        return params, rays.to(mesh.device), grid.to(mesh.device), c2w.to(mesh.device)

    def step(params, step: int, rays, n_rays: int, grid, c2w, batch_idx=None,
             draws=None, generator=None):
        if batch_idx is None:
            batch_idx = nof_runner.draw_batch(st.n_rand, n_rays, generator, rays.device)
        if draws is None:
            draws = nof_render.draw_samples(st.rcfg, st.n_rand, generator, rays.device)
        mine = mesh.rows(st.n_rand)
        optimizer.zero_grad()
        loss, metrics = loss_fn(params, rays[batch_idx[mine]], grid, c2w, step,
                                draws.rows(mine))
        loss.backward()
        metrics = reduce_metrics(metrics, mesh)
        optimizer.step()
        return metrics

    return step, place


def make_dp_train_loop(st: nof_runner.TrainStatics, optimizer: nof_runner.NofOptimizer,
                       mesh: Mesh, shard_table: bool = True):
    """The dp analogue of ``nof/runner.make_train_loop``, with its
    ``train_many(params, step0, rays, n_rays, grid, c2w, n_inner,
    generator=None, draws=None)`` signature, so that ``NofRunner`` swaps it
    in: ``draws`` gives each step's whole-batch indices and jitter."""
    step, _ = make_dp_train_step(st, optimizer, mesh, shard_table)

    def train_many(params, step0: int, rays, n_rays: int, grid, c2w, n_inner: int,
                   generator=None, draws: nof_runner.TrainDraws | None = None):
        metrics = None
        for i in range(n_inner):
            idx = sd = None
            if draws is not None:
                idx, sd = draws(step0 + i, n_rays)
                idx, sd = idx.to(rays.device), sd.to(rays.device)
            metrics = step(params, step0 + i, rays, n_rays, grid, c2w,
                           batch_idx=idx, draws=sd, generator=generator)
        return metrics

    return train_many
