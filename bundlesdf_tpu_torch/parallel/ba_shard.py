"""Distributed bundle adjustment: residual blocks sharded over ranks (port
of ``bundlesdf_tpu/parallel/ba_shard.py``).

The normal equations H = sum_e J_e^T W J_e and b = sum_e J_e^T W r are a
pure reduction over residuals.  Each rank assembles the feature term on its
share of the sparse edges and the dense term on its share of the frame
pairs (``Mesh.rows``); ``tracking/ba.bundle_adjust``'s ``reduce`` hook sums
H, b and the chi2 over the mesh, and every rank solves the small dense
system identically (replicated poses in, replicated poses out).
"""
from __future__ import annotations

from ..tracking import ba as ba_mod
from .mesh import Mesh


def make_sharded_bundle_adjust(mesh: Mesh, params: ba_mod.BAParams, n_frames: int):
    """A BA function with ``bundle_adjust``'s arguments (less ``params`` and
    ``n_frames``), every rank handing it the whole edge and pair arrays and
    assembling its share of them."""

    def sharded_ba(poses, fixed, ii, jj, pi, pj, corr_valid, pair_i, pair_j,
                   pair_valid, xyz_ds, normal_ds, valid_ds, K_ds):
        e, p = mesh.rows(ii.shape[0]), mesh.rows(pair_i.shape[0])
        return ba_mod.bundle_adjust(
            poses, fixed, ii[e], jj[e], pi[e], pj[e], corr_valid[e],
            pair_i[p], pair_j[p], pair_valid[p], xyz_ds, normal_ds, valid_ds, K_ds,
            params, n_frames, reduce=mesh.all_reduce)

    return sharded_ba
