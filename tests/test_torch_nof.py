"""Neural Object Field model, rendering and losses of the PyTorch port
against the JAX package: the same converted parameters, the same numpy
inputs, and the jitter uniforms that the JAX functions draw from their keys
handed to the port."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from bundlesdf_tpu.models import nof as jnof
from bundlesdf_tpu.nof import losses as jlosses
from bundlesdf_tpu.nof import render as jrender
from bundlesdf_tpu.ops import hashgrid as jhg
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import losses as tlosses
from bundlesdf_tpu_torch.nof import render as trender
from bundlesdf_tpu_torch.ops import hashgrid as thg

torch.set_num_threads(2)

# Small budget: 2 dense f32 levels (16, 32), 64 rays x (16 + 8) samples.
SMALL = dict(n_rand=64, n_samples=16, n_around=8, num_levels=2, finest_res=32,
             log2_hashmap=22, n_march=32, num_frames=4, occ_res=16)


def render_draws(key, n, rcfg):
    """The uniforms jax render_rays(key, ...) draws, as the port's
    SampleDraws (key -> (key, k_imp); key -> k1, k2, k3 in sample_z_vals;
    k_imp -> sample_pdf's uniforms when n_importance > 0)."""
    key, k_imp = jax.random.split(key)
    k1, k2, k3 = jax.random.split(key, 3)

    def u(k, s):
        return torch.from_numpy(np.array(jax.random.uniform(k, (n, s))))

    return trender.SampleDraws(u(k1, rcfg.n_samples),
                               u(k2, rcfg.n_samples_around_depth),
                               u(k3, rcfg.n_samples_around_depth),
                               u(k_imp, rcfg.n_importance) if rcfg.n_importance else None)


def _specs(frame_features=0):
    args = (2, 2, 16, 32, 22)
    js = jnof.NofSpec(grid=jhg.HashGridSpec(*args, layout="cell", scatter="xla"),
                      frame_features=frame_features, num_frames=4)
    ts = tnof.NofSpec(grid=thg.HashGridSpec(*args, layout="cell", scatter="xla"),
                      frame_features=frame_features, num_frames=4)
    return js, ts


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_init_and_params_from_jax_round_trip():
    js, ts = _specs(frame_features=3)
    jp = _tree_np(jax.jit(jnof.init_nof_params, static_argnums=1)(
        jax.random.PRNGKey(0), js))
    tp = tnof.params_from_jax(jp, device="cpu")
    back = tnof.params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], leaf)
    for t in jax.tree_util.tree_leaves(tp):
        assert t.requires_grad and t.is_leaf and t.dtype == torch.float32
    # the port's own seeded init has the JAX init's shapes and ranges
    own = tnof.init_nof_params(ts, seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == shapes
    assert torch.all(own["sigma"]["b1"] == 0.1)
    assert float(own["table"].detach().abs().max()) <= 1e-4
    bound = 1.0 / np.sqrt(ts.input_ch)
    assert float(own["sigma"]["w0"].detach().abs().max()) <= bound
    again = tnof.init_nof_params(ts, seed=0, device="cpu")
    torch.testing.assert_close(own["color"]["w1"], again["color"]["w1"], rtol=0, atol=0)


def test_pose_array_matrices():
    js, ts = _specs()
    rng = np.random.default_rng(0)
    pose = (rng.normal(size=(4, 6)) * 0.8).astype(np.float32)
    ids = np.array([0, 3, 1, 1, 2], np.int32)
    ref = np.asarray(jnof.pose_array_matrices(jnp.asarray(pose), js, jnp.asarray(ids)))
    out = tnof.pose_array_matrices(torch.from_numpy(pose), ts,
                                   torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[0].numpy(), np.eye(4, dtype=np.float32))


@pytest.mark.parametrize("frame_features", [0, 3])
def test_nof_forward_and_sdf(frame_features):
    js, ts = _specs(frame_features)
    jp = _tree_np(jnof.init_nof_params(jax.random.PRNGKey(1), js))
    jp["table"] = jp["table"] * 1000  # features well above the init's 1e-4
    tp = tnof.params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.1, 1.1, (24, 10, 3)).astype(np.float32)
    dirs = rng.normal(size=(24, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    fids = rng.integers(0, 4, 24).astype(np.int32)
    jraw, jvalid = jnof.nof_forward(jp, js, jnp.asarray(pts), jnp.asarray(dirs),
                                    jnp.asarray(fids))
    with torch.no_grad():
        traw, tvalid = tnof.nof_forward(tp, ts, torch.from_numpy(pts),
                                        torch.from_numpy(dirs),
                                        torch.from_numpy(fids).long())
        tsdf = tnof.nof_sdf(tp, ts, torch.from_numpy(pts.reshape(-1, 3)))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jraw = np.asarray(jraw)
    # f32 MLP: matmul summation order only
    np.testing.assert_allclose(traw.numpy(), jraw, rtol=0,
                               atol=1e-5 * np.abs(jraw).max())
    jsdf = np.asarray(jnof.nof_sdf(jp, js, jnp.asarray(pts.reshape(-1, 3))))
    np.testing.assert_allclose(tsdf.numpy(), jsdf, rtol=0,
                               atol=1e-5 * np.abs(jsdf).max())


def _small_pair(pose_scale=0.3):
    """JAX and port builds of the same small budget, with equal weights (the
    JAX init converted) and a nonzero pose correction."""
    spec, rcfg, weights, jp, rays, c2w, grid = __graft_entry__._build_nof(**SMALL)
    jp = _tree_np(jp)
    jp["pose_array"] = (np.random.default_rng(2).normal(size=(4, 6))
                        * pose_scale).astype(np.float32)
    tspec, trcfg, tweights, _, trays, tc2w, tgrid = tentry.build_nof(
        **SMALL, device="cpu")
    tp = tnof.params_from_jax(jp, device="cpu")
    np.testing.assert_array_equal(trays.numpy(), np.asarray(rays))
    np.testing.assert_array_equal(tc2w.numpy(), np.asarray(c2w))
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(grid))
    return (spec, rcfg, weights, jp, rays, c2w, grid), (tspec, trcfg, tweights,
                                                        tp, trays, tc2w, tgrid)


def test_render_rays_matches_jax():
    (spec, rcfg, _, jp, rays, c2w, grid), (tspec, trcfg, _, tp, trays, tc2w,
                                           tgrid) = _small_pair()
    assert tuple(trcfg) == tuple(rcfg)  # same static render config
    key = jax.random.PRNGKey(4)
    render = jax.jit(jrender.render_rays, static_argnums=(2, 3))
    jout = render(key, jp, spec, rcfg, grid, rays, c2w, 0.01)
    draws = render_draws(key, SMALL["n_rand"], trcfg)
    with torch.no_grad():
        tout = trender.render_rays(tp, tspec, trcfg, tgrid, trays, tc2w, 0.01, draws)
    np.testing.assert_array_equal(tout["valid_samples"].numpy(),
                                  np.asarray(jout["valid_samples"]))
    assert tout["valid_samples"].any()
    for k, tol in (("z_vals", 2e-5), ("pts", 2e-5), ("raw", 1e-5),
                   ("weights", 1e-5), ("rgb_map", 1e-5)):
        ref = np.asarray(jout[k])
        assert tout[k].shape == ref.shape, k
        np.testing.assert_allclose(tout[k].numpy(), ref, rtol=0,
                                   atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


@pytest.mark.parametrize("perturb", [True, False])
def test_render_rays_importance_matches_jax(perturb):
    """render_rays with n_importance 16: sample_pdf on the first pass's
    weights (the JAX k_imp uniforms, or linspace when not perturbed), the
    new points queried, the stable merge sort and the recomposite, against
    the JAX render: the same validity, values within the tolerances of
    test_render_rays_matches_jax."""
    (spec, rcfg, _, jp, rays, c2w, grid), (tspec, trcfg, _, tp, trays, tc2w,
                                           tgrid) = _small_pair()
    rcfg = rcfg._replace(n_importance=16, perturb=perturb)
    trcfg = trcfg._replace(n_importance=16, perturb=perturb)
    key = jax.random.PRNGKey(6)
    jout = jax.jit(jrender.render_rays, static_argnums=(2, 3))(
        key, jp, spec, rcfg, grid, rays, c2w, 0.01)
    with torch.no_grad():
        tout = trender.render_rays(tp, tspec, trcfg, tgrid, trays, tc2w, 0.01,
                                   render_draws(key, SMALL["n_rand"], trcfg))
    S = SMALL["n_samples"] + SMALL["n_around"] + 16
    assert tout["z_vals"].shape == (SMALL["n_rand"], S)
    np.testing.assert_array_equal(tout["valid_samples"].numpy(),
                                  np.asarray(jout["valid_samples"]))
    assert tout["valid_samples"][:, -16:].any()
    for k, tol in (("z_vals", 2e-5), ("pts", 2e-5), ("raw", 1e-5),
                   ("weights", 1e-5), ("rgb_map", 1e-5)):
        ref = np.asarray(jout[k])
        np.testing.assert_allclose(tout[k].numpy(), ref, rtol=0,
                                   atol=tol * max(1.0, np.abs(ref).max()), err_msg=k)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    """sample_pdf against the JAX function, random (the key's uniforms) and
    det (linspace, whose 0 and 1 equal cdf values) modes, on weights that
    tie the cdf: all-zero rows (a uniform pdf) and rows whose mass sits in
    3 bins (the f32 prefix sums after them stay equal).  z within 2e-5 of
    the largest bin value: the cdf is an f32 prefix sum in another order
    (XLA's CPU cumsum is a tree scan, torch's a running sum; up to 9 of 20
    entries of a row differ by 1 ulp), and the inverse transform divides
    that ulp by the bin's probability (1.4e-5 seen on a 1e-5-weight bin)."""
    rng = np.random.default_rng(8)
    N, B, n = 64, 20, 32
    bins = np.sort(rng.uniform(0.3, 1.8, (N, B)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (N, B - 1)).astype(np.float32)
    w[:16] = 0.0
    w[16:32] = 0.0
    w[16:32, :3] = 1e9
    cdf = np.cumsum(np.float32(1) * (w + 1e-5) / (w + 1e-5).sum(-1, keepdims=True), -1,
                    dtype=np.float32)
    assert (np.diff(cdf[16:32], axis=-1) == 0).any()  # tied cdf values
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jrender.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), n, det=det))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (N, n))))
    out = trender.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n, det=det, u=u)
    assert out.shape == (N, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5 * bins.max())


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    N, S = 40, 24
    z = np.sort(rng.uniform(0.5, 1.5, (N, S)), axis=-1).astype(np.float32)
    d = rng.uniform(0.6, 2.4, (N,)).astype(np.float32)  # some beyond far
    sdf = rng.normal(scale=0.5, size=(N, S)).astype(np.float32)
    sw = rng.uniform(0, 2, (N, S)).astype(np.float32)
    ray_w = rng.uniform(0, 1, (N,)).astype(np.float32)
    logits = rng.normal(size=(N, S, 3)).astype(np.float32)
    w = jlosses.LossWeights()
    tw = tlosses.LossWeights()
    assert tuple(tw) == tuple(w)
    J = lambda *a: [jnp.asarray(v) for v in a]  # noqa: E731
    T = lambda *a: [torch.from_numpy(v) for v in a]  # noqa: E731
    for trunc in (0.01, 0.05):
        for jm, tm in zip(jlosses.sdf_masks(*J(z, d[:, None]), trunc, w),
                          tlosses.sdf_masks(*T(z, d[:, None]), trunc, tw)):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jl = jlosses.sdf_losses(*J(z, d[:, None], sdf), trunc, jnp.asarray(sw), w)
        tl = tlosses.sdf_losses(*T(z, d[:, None], sdf), trunc, torch.from_numpy(sw), tw)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    np.testing.assert_allclose(
        float(tlosses.depth_loss(*T(z, sdf, d, ray_w), tw)),
        float(jlosses.depth_loss(*J(z, sdf, d, ray_w), w)), rtol=1e-5)
    front = (z < d[:, None] - 0.01).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.fs_rgb_loss(*T(logits, front, sw))),
        float(jlosses.fs_rgb_loss(*J(logits, front, sw))), rtol=1e-5)
    for decay in ("", "linear", "exp"):
        for step in (0, 37, 500):
            np.testing.assert_allclose(
                tlosses.truncation_value(step, 500, 0.01, 0.04, 2.0, decay),
                float(jlosses.truncation_value(step, 500, 0.01, 0.04, 2.0, decay)),
                rtol=1e-6)


def test_entry_loss_matches_jax(monkeypatch):
    """The loss of __graft_entry__.entry()'s function == the port's entry
    function at a small budget (same weights, rays, grid and jitter)."""
    monkeypatch.setattr(__graft_entry__, "_build_nof",
                        functools.partial(__graft_entry__._build_nof, **SMALL))
    fn, (jp, rays, c2w, grid, key) = __graft_entry__.entry()
    ref = float(jax.jit(fn)(jp, rays, c2w, grid, key))
    tspec, trcfg, tweights, _, trays, tc2w, tgrid = tentry.build_nof(
        **SMALL, device="cpu")
    tp = tnof.params_from_jax(_tree_np(jp), device="cpu")
    tfn = tentry.make_entry_fn(tspec, trcfg, tweights)
    with torch.no_grad():
        out = float(tfn(tp, trays, tc2w, tgrid,
                        render_draws(key, SMALL["n_rand"], trcfg)))
    assert np.isfinite(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
