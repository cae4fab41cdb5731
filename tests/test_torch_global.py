"""The port's offline global refinement against the JAX package's:
``BundleSdf.run_global_nerf`` on the sphere and ``cfg_refine`` of
tests/test_pipeline.py:157-193 (steps cut) with shared weights and draws;
the train step at a level mix like the offline budget's (dense f32, dense
bf16 and hashed levels, frame features, forced microbatches); and
``entry.run_global_refine`` on an artifact trail."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import __graft_entry__
from synthetic import make_sphere_dataset
from test_torch_pipeline import jax_init
from test_torch_train import _step_draws
from bundlesdf_tpu.config import default_nof_config as jax_nof_cfg
from bundlesdf_tpu.config import default_track_config as jax_track_cfg
from bundlesdf_tpu.models import nof as jnof
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu.pipeline.bundlesdf import GLCAM_IN_CVCAM
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.config import Cfg, default_nof_config, default_track_config
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.pipeline import artifacts as tart
from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

torch.set_num_threads(2)

# tests/test_pipeline.py:181-186, n_step cut 150 -> 30
REFINE = {"n_step": 30, "N_rand": 256, "N_samples": 8, "N_samples_around_depth": 8,
          "num_levels": 2, "finest_res": 32, "log2_hashmap_size": 14,
          "frame_features": 2, "octree_smallest_voxel_size": 0.05,
          "octree_dilate_size": 0.05, "mesh_resolution": 0.04, "loop_chunk": 5}


def _sphere_frames():
    data = make_sphere_dataset(n_views=4, H=32, W=32)
    frames = [{"color": (data["images"][i] * 255).astype(np.uint8),
               "depth": data["depths"][i],
               "mask": (data["masks"][i] > 0).astype(np.uint8) * 255,
               "cam_in_ob": data["poses"][i] @ np.linalg.inv(GLCAM_IN_CVCAM)}
              for i in range(4)]
    return data, frames


def _jax_batches(over):
    """The JAX runner's PRNGKey(42) step draws for a run of ``over``."""
    st = types.SimpleNamespace(
        n_rand=over["N_rand"], microbatch=0,
        rcfg=types.SimpleNamespace(n_samples=over["N_samples"],
                                   n_samples_around_depth=over["N_samples_around_depth"]))
    return lambda step, n_rays: _step_draws(jax.random.PRNGKey(42), step, st, n_rays)


@pytest.fixture(scope="module")
def refined(tmp_path_factory):
    """Both packages' run_global_nerf from the same frames, the JAX init's
    weights and the JAX key's batches, texture bake on."""
    data, frames = _sphere_frames()
    J = JBundleSdf(cfg_track=jax_track_cfg(), out_dir=str(tmp_path_factory.mktemp("j")),
                   use_nof=False)
    J.K = data["K"]
    jm, jp = J.run_global_nerf(frames, cfg_refine=jax_nof_cfg().merged(REFINE),
                               get_texture=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(trunner.nof_model, "init_nof_params", jax_init)
    try:
        T = BundleSdf(cfg_track=default_track_config(), use_nof=False, device="cpu",
                      nof_draws=_jax_batches(REFINE))
        T.K = data["K"]
        tm, tp = T.run_global_nerf(frames, cfg_refine=default_nof_config().merged(REFINE),
                                   get_texture=True)
    finally:
        mp.undo()
    return J, (jm, jp), T, (tm, tp)


def test_run_global_nerf_matches_jax(refined):
    """Equal ray pools and normalization; after 30 steps the refined poses
    agree within 1e-4 (measured 6.0e-6), the cleaned meshes have vertex
    counts within 1% (measured equal) and lie within a tenth of a
    marching voxel of each other (measured 6.4e-5 m against 0.04 m)."""
    J, (jm, jp), T, (tm, tp) = refined
    np.testing.assert_array_equal(T.global_nof.rays_np, J.global_nof.rays_np)
    assert T.sc_factor == pytest.approx(J.sc_factor, rel=1e-12)
    np.testing.assert_allclose(T.translation, J.translation, rtol=0, atol=1e-12)
    assert tp.shape == jp.shape == (4, 4, 4)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    assert len(jm.vertices) > 500
    assert abs(len(tm.vertices) - len(jm.vertices)) <= 0.01 * len(jm.vertices)
    d = max(cKDTree(jm.vertices).query(tm.vertices)[0].max(),
            cKDTree(tm.vertices).query(jm.vertices)[0].max())
    assert d <= 0.1 * REFINE["mesh_resolution"], d
    ext = tm.vertices.max(0) - tm.vertices.min(0)
    assert np.all(ext < 1.5)  # world scale (tests/test_pipeline.py:192)


def test_global_texture_bake_matches_jax(refined):
    """The bake under get_texture, held against the JAX bake functions on
    the port's own refined mesh and the same frames (the two meshes differ
    by ~6e-5 m, which moves the charted atlas's discrete choices): the same
    atlas and UVs (NaN where the reference's charts give a face none),
    vertex colors and texels within 1 (uint8) on all but 0.1% of them."""
    from bundlesdf_tpu.nof import texture as jtex
    from bundlesdf_tpu.utils.mesh import Mesh as JMesh

    _, frames = _sphere_frames()
    J, _, T, (tm, _) = refined
    rgbs = np.stack([f["color"] for f in frames]).astype(np.float32) / 255.0
    depths = np.stack([f["depth"] for f in frames]).astype(np.float32)
    masks = np.stack([f["mask"] for f in frames]).astype(np.float32)
    cams = np.stack([f["cam_in_ob"] for f in frames])
    plain = JMesh(tm.vertices, tm.faces)
    jm = jtex.bake_vertex_colors(plain, None, rgbs, depths, masks, cams, T.K)
    jm, jt = jtex.bake_texture_from_train_images(jm, rgbs, depths, masks, cams, T.K)
    assert tm.atlas == "charted"
    np.testing.assert_array_equal(tm.face_uv, jm.face_uv)
    assert (np.abs(tm.vertex_colors.astype(int) - jm.vertex_colors).max(-1) > 1).mean() <= 1e-3
    assert T.texture.shape == jt.shape == (1024, 1024, 3)
    assert (np.abs(T.texture.astype(int) - jt).max(-1) > 1).mean() <= 1e-3
    assert (T.texture != 128).any(-1).mean() > 0.1


@pytest.mark.parametrize("microbatch", [16])
def test_offline_level_mix_step_matches_jax(microbatch):
    """One step at a level mix like the offline budget's (num_levels 4,
    finest_res 128, log2 table 20: dense f32 R = 16 and 32, dense bf16
    R = 64, hashed R = 128), frame_features 2, forced microbatches.  Per
    chunk the losses agree to rtol 1e-4; the accumulated gradients: MLP,
    pose and feature arrays within 1e-4 of each leaf's largest gradient,
    the table's f32 and hashed levels within 1e-3 of theirs, the bf16 level
    within 2.5 bf16 ulps of its largest (tests/test_hashgrid.py:450)."""
    over = dict(n_rand=64, n_samples=16, n_around=8, num_levels=4, finest_res=128,
                log2_hashmap=20, n_march=32, num_frames=4, occ_res=16)
    spec, rcfg, weights, _, rays, c2w, grid = __graft_entry__._build_nof(**over)
    spec = spec._replace(frame_features=2, grid=spec.grid._replace(scatter="xla"))
    assert [(p["res"], p["dense"]) for p in spec.grid.level_params()] == [
        (16, True), (32, True), (64, True), (128, False)]
    jp = jnof.init_nof_params(jax.random.PRNGKey(0), spec)
    st = jrunner.TrainStatics(spec=spec, rcfg=rcfg, weights=weights, n_rand=64, n_step=500,
                              trunc=0.01, trunc_start=0.01, trunc_decay_type="",
                              sc_factor=1.0, microbatch=microbatch)
    jvg = jax.jit(jax.value_and_grad(jrunner.make_loss_fn(st), has_aux=True),
                  static_argnums=5)
    key = jax.random.PRNGKey(7)
    idx, draws = _step_draws(key, 0, st, int(rays.shape[0]))
    batch = jnp.asarray(rays)[jnp.asarray(idx.numpy())]
    _, kr = jax.random.split(jax.random.fold_in(key, 0))
    n_chunks = 64 // microbatch
    keys = jax.random.split(kr, n_chunks)
    jgrads, jl = None, []
    for c in range(n_chunks):
        sl = slice(c * microbatch, (c + 1) * microbatch)
        (l, _), g = jvg(jp, keys[c], batch[sl], grid, c2w, 0)
        jl.append(float(l))
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
    jgrads = jax.tree_util.tree_map(lambda g: np.asarray(g) / n_chunks, jgrads)

    tspec, trcfg, tweights, _, trays, tc2w, tgrid = tentry.build_nof(**over, device="cpu")
    tspec = tspec._replace(frame_features=2)
    assert tspec.grid.big_dtype == "bfloat16" and tspec.grid.scatter == "xla"
    tp = tnof.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tst = trunner.TrainStatics(tspec, trcfg, tweights, 64, 500, 0.01, 0.01, "", 1.0,
                               microbatch)
    tloss = trunner.make_loss_fn(tst)
    tbatch = trays[idx]
    tl = []
    for c in range(n_chunks):
        sl = slice(c * microbatch, (c + 1) * microbatch)
        loss, _ = tloss(tp, tbatch[sl], tgrid, tc2w, 0, draws.rows(sl))
        loss.backward()
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)

    def leaf(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree

    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads):
        got = leaf(tp, path).grad.numpy() / n_chunks
        scale = max(np.abs(ref).max(), 1e-12)
        if path[0].key != "table":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale,
                                       err_msg=str(path))
            continue
        for p in spec.grid.level_params():
            sl = slice(p["offset"] * 2, (p["offset"] + p["size"]) * 2)
            r, g = ref[sl], got[sl]
            s = max(np.abs(r).max(), 1e-12)
            bf16 = p["dense"] and p["res"] == 64
            np.testing.assert_allclose(g, r, rtol=0, atol=s * (2.5 / 256 if bf16 else 1e-3),
                                       err_msg=f"table level R={p['res']}")


def test_run_global_refine_entry(tmp_path, monkeypatch):
    """entry.run_global_refine on the CPU from an artifact trail: the frames
    and the saved normalization come back from disk, K from cam_K.txt beside
    the run folder, and it writes the textured OBJ set and the poses.  The
    offline budget is swapped for the small one of the other tests: the
    plumbing is under test here, the budget runs on the card."""
    data, frames = _sphere_frames()
    out = tmp_path / "run"
    trail = types.SimpleNamespace(bundler=types.SimpleNamespace(keyframes=[]))
    for i, f in enumerate(frames):
        kf = types.SimpleNamespace(id_str=f"{i:04d}", pose_in_model=f["cam_in_ob"],
                                   nerfed=True, color=f["color"], depth=f["depth"],
                                   fg_mask=f["mask"] > 0)
        trail.bundler.keyframes.append(kf)
        tart.save_newframe_result(trail, kf, str(out), 2)
    np.savetxt(tmp_path / "cam_K.txt", data["K"])
    # the online normalization as the joint loop saves it: the scene bounds
    # of the frames with the 0.7 margin (the sphere sits at the origin)
    cfg = default_nof_config().merged({"sc_factor": 2.0958, "translation": [0.0, 0.0, 0.0]})
    cfg.save(str(out / "config_nerf.yml"))
    seen = {}
    orig = BundleSdf.run_global_nerf

    def small(self, frames_data, cfg_refine=None, get_texture=False):
        seen.update(n_step=cfg_refine["n_step"], levels=cfg_refine["num_levels"],
                    K=self.K.copy(), sc=self.sc_factor, n=len(frames_data))
        return orig(self, frames_data, Cfg.wrap(dict(cfg_refine.merged(REFINE),
                                                     n_step=cfg_refine["n_step"])),
                    get_texture)

    monkeypatch.setattr(BundleSdf, "run_global_nerf", small)
    pipe, mesh, poses = tentry.run_global_refine(str(out), refine_steps=30, device="cpu")
    assert seen["n_step"] == 30 and seen["levels"] == 16 and seen["n"] == 4
    np.testing.assert_array_equal(seen["K"], data["K"])
    assert seen["sc"] == 2.0958 and pipe.global_nof.cfg["sc_factor"] == 2.0958
    assert pipe.global_nof.total_step == 30
    for name in ("textured_mesh.obj", "textured_mesh.mtl", "textured_mesh.png",
                 "poses_after_global_refine.txt"):
        assert (out / name).exists(), name
    np.testing.assert_allclose(np.loadtxt(out / "poses_after_global_refine.txt"),
                               poses.reshape(-1, 4), rtol=0, atol=1e-6)
    from bundlesdf_tpu_torch.nof.texture import load_textured_obj

    back, tex = load_textured_obj(str(out / "textured_mesh.obj"))
    assert len(back.faces) == len(mesh.faces) > 0
    np.testing.assert_array_equal(tex, pipe.texture)
    # a trail without image dumps (SPDLOG 1) has nothing to refine
    tart.save_newframe_result(trail, trail.bundler.keyframes[0], str(tmp_path / "bare"), 1)
    with pytest.raises(RuntimeError, match="no tracked frames"):
        tentry.run_global_refine(str(tmp_path / "bare"), device="cpu")
