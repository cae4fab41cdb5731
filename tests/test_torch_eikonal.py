"""The NOF's eikonal loss in the port's train step against the JAX
package's: ``make_loss_fn`` with ``eikonal_weight`` > 0 differentiates the
normals ``d nof_sdf / d pts`` once more, through the hash-grid encode's
custom backward, in both layouts; the loss, every gradient, and the eikonal
term's own table and pose gradients are held to ``jax.grad`` on the same
weights, batch and draws."""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from test_torch_nof import render_draws
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import runner as trunner

torch.set_num_threads(2)

SMALL = dict(n_rand=64, n_samples=16, n_around=8, num_levels=2, finest_res=32,
             log2_hashmap=22, n_march=32, num_frames=4, occ_res=16)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_grads(tree):
    """{path: gradient} of a port parameter dict."""
    out = {}
    for k, v in tree.items():
        for j, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            g = torch.zeros_like(t) if t.grad is None else t.grad
            out[k if j is None else f"{k}/{j}"] = g.detach().numpy().copy()
    return out


def _jax_grads(tree):
    out = {}
    for k, v in tree.items():
        for j, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[k if j is None else f"{k}/{j}"] = np.asarray(t)
    return out


@pytest.mark.parametrize("layout", ["exact", "cell"])
def test_eikonal_loss_and_grads_match_jax(layout):
    """The loss function with eikonal_weight 0.1 (tests/test_nof.py:131's
    value) and N_importance 8, on the JAX init's weights (the table scaled
    up to features of ~0.1, a nonzero pose correction), the same batch and
    the JAX key's draws: the loss and its terms within rtol 1e-4, and the
    gradient of every leaf (table, MLPs, pose array) within 1e-4 of its
    largest against ``jax.grad``.  Then the eikonal term alone: its table
    gradient, which reaches the table only through the rows the encode's
    backward reads, is nonzero and equal to JAX's within 1e-4 of its
    largest."""
    spec, rcfg, weights, jp, rays, c2w, grid = __graft_entry__._build_nof(**SMALL)
    spec = spec._replace(grid=spec.grid._replace(layout=layout, scatter="xla"))
    rcfg = rcfg._replace(n_importance=8)
    weights = weights._replace(eikonal_weight=0.1)
    jp = _tree_np(jp)
    jp["table"] = jp["table"] * 1000
    jp["pose_array"] = (np.random.default_rng(2).normal(size=(4, 6)) * 0.3).astype(np.float32)
    st = jrunner.TrainStatics(spec=spec, rcfg=rcfg, weights=weights,
                              n_rand=SMALL["n_rand"], n_step=500, trunc=0.01,
                              trunc_start=0.01, trunc_decay_type="", sc_factor=1.0)
    key = jax.random.PRNGKey(11)
    jloss = jrunner.make_loss_fn(st)
    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, key, rays, grid, c2w, 0)
    jg_ek = jax.jit(jax.grad(lambda p, *a: jloss(p, *a)[1]["eikonal_loss"]))(
        jp, key, rays, grid, c2w, 0)

    tspec, trcfg, tweights, _, trays, tc2w, tgrid = tentry.build_nof(**SMALL, device="cpu")
    tst = trunner.TrainStatics(
        tspec._replace(grid=tspec.grid._replace(layout=layout)),
        trcfg._replace(n_importance=8), tweights._replace(eikonal_weight=0.1),
        SMALL["n_rand"], 500, 0.01, 0.01, "", 1.0)
    tloss = trunner.make_loss_fn(tst)
    draws = render_draws(key, SMALL["n_rand"], tst.rcfg)
    grads = []
    for term in ("loss", "eikonal_loss"):
        tp = tnof.params_from_jax(jp, device="cpu")
        loss, tm = tloss(tp, trays, tgrid, tc2w, 0, draws)
        tm[term].backward()
        grads.append(_leaf_grads(tp))
    for k in ("loss", "rgb_loss", "fs_loss", "sdf_loss", "eikonal_loss"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(tm["eikonal_loss"].detach()) > 0
    for name, ref in _jax_grads(jg).items():
        np.testing.assert_allclose(grads[0][name], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)
    ref = np.asarray(jg_ek["table"])
    assert np.abs(ref).max() > 0 and np.abs(grads[1]["table"]).max() > 0
    np.testing.assert_allclose(grads[1]["table"], ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(grads[1]["pose_array"], np.asarray(jg_ek["pose_array"]),
                               rtol=0, atol=1e-4 * np.abs(np.asarray(jg_ek["pose_array"])).max())
