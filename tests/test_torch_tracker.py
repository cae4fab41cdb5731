"""The port's tracker end to end against the JAX package: Frame, the
Bundler's admission and BA-subset selection, and a tracking-only
BundleSdf.run over the 96 x 96 cube sequence with shared RANSAC draws."""
import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from synthetic_cube import cube_model_points, make_cube_sequence
from test_pipeline import small_track_cfg
from bundlesdf_tpu.config import default_track_config as jax_track_cfg
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf
from bundlesdf_tpu.tracking import frame as jframe
from bundlesdf_tpu.tracking.pool import Bundler as JBundler
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_track_config
from bundlesdf_tpu_torch.tracking import frame as tframe
from bundlesdf_tpu_torch.tracking.pool import Bundler as TBundler
from bundlesdf_tpu_torch.utils import metrics

torch.set_num_threads(2)

N_FRAMES = 6


def jax_draws(seed, shape):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


def port_cfg(cfg):
    """The same tracker config, as the port's own Cfg."""
    return Cfg.wrap(default_track_config().merged(cfg))


@pytest.fixture(scope="module")
def data():
    return make_cube_sequence(n_frames=N_FRAMES, deg_per_frame=3.0)


def test_frame_fields_equal_jax(data):
    cfg = small_track_cfg()
    cfg["depth_processing"]["denoise_cloud"] = True
    fj = jframe.Frame(data["colors"][1], data["depths"][1], data["K"], 1, "0001", cfg,
                      fg_mask=data["masks"][1], occ_mask=np.zeros((96, 96), np.uint8))
    ft = tframe.Frame(data["colors"][1], data["depths"][1], data["K"], 1, "0001",
                      port_cfg(cfg), fg_mask=data["masks"][1],
                      occ_mask=np.zeros((96, 96), np.uint8))
    for k in ("depth", "xyz", "normals", "valid", "gray", "fg_mask", "roi", "pose_in_model"):
        np.testing.assert_array_equal(getattr(ft, k), getattr(fj, k), err_msg=k)
    assert ft.count_valid_points() == fj.count_valid_points() > 1000
    assert (ft.status, ft.ref_frame_id, ft.nerfed) == (fj.status, fj.ref_frame_id, fj.nerfed)
    for f in (fj, ft):
        f.point_cloud_denoise()
        f.set_new_init_coordinate()
    np.testing.assert_array_equal(ft.depth, fj.depth)
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.pose_in_model, fj.pose_in_model)
    assert (tframe.OTHER, tframe.FAIL, tframe.NO_BA) == (jframe.OTHER, jframe.FAIL, jframe.NO_BA)
    f0j = jframe.Frame(data["colors"][0], data["depths"][0], data["K"], 0, "0", cfg,
                       fg_mask=data["masks"][0])
    f0t = tframe.Frame(data["colors"][0], data["depths"][0], data["K"], 0, "0",
                       port_cfg(cfg), fg_mask=data["masks"][0])
    assert tframe.compute_covisibility(ft, f0t) == jframe.compute_covisibility(fj, f0j)


METHODS = ["greedy_rot", "nearest_rotations", "normal_orientation_nearest",
           "normal_orientation_greedy", "greedy_covisible_points", "near_enough_rot",
           "max_edge"]


def _pool(module, bundler_cls, method, device_kw):
    """A keyframe pool on a 16 x 16 fronto-parallel plane: keyframes every
    10 deg about x, a new frame at 75 deg, and admission of 3 candidates."""
    cfg = jax_track_cfg() if module is jframe else default_track_config()
    cfg["bundle"]["max_BA_frames"] = 4
    cfg["bundle"]["subset_selection_method"] = method
    b = bundler_cls(cfg, **device_kw)
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)

    def frame(fid, deg):
        f = module.Frame(np.zeros((16, 16, 3), np.uint8), np.full((16, 16), 0.5, np.float32),
                         K, fid, f"{fid:05d}", cfg)
        f.pose_in_model = np.eye(4, dtype=np.float32)
        f.pose_in_model[:3, :3] = Rotation.from_euler("x", deg, degrees=True).as_matrix()
        return f

    b.firstframe = frame(0, 0.0)
    assert b.check_and_add_keyframe(b.firstframe)
    b.keyframes += [frame(i, 10.0 * i) for i in range(1, 8)]
    b.newframe = frame(99, 75.0)
    b.select_keyframes_for_ba()
    admitted = [b.check_and_add_keyframe(frame(100 + i, d)) for i, d in
                enumerate((72.0, 83.0, 200.0))]
    return [f.id for f in b.local_frames], admitted, [f.id for f in b.keyframes]


@pytest.mark.parametrize("method", METHODS)
def test_bundler_selection_and_admission_equal_jax(method):
    ref = _pool(jframe, JBundler, method, {})
    out = _pool(tframe, TBundler, method, {"device": "cpu"})
    assert out == ref
    assert len(out[0]) == 4 and 99 in out[0]


def _run(tracker, data):
    frames = [tracker.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                          mask=data["masks"][k]) for k in range(N_FRAMES)]
    poses = np.stack([tracker.poses_log[f"{k:04d}"] for k in range(N_FRAMES)])
    return poses, [f.status for f in frames], [f.id for f in tracker.bundler.keyframes]


def test_tracking_only_matches_jax(data, tmp_path):
    """Per-frame poses within 1 mm and 0.2 deg of the JAX run, the same
    keyframes and FAIL statuses, and sub-cm mean ADD.  The JAX programs are
    jitted whole, so their warp arithmetic differs from the port's by about
    1e-5 (see tests/test_torch_fused.py) and the match tables drift apart a
    little from frame 1 on; the poses stay close."""
    from bundlesdf_tpu_torch.utils import profiler as tprof

    tprof.reset()
    p_t, st_t, kf_t = _run(entry.build_tracker(port_cfg(small_track_cfg()), device="cpu",
                                               ransac_draws=jax_draws), data)
    p_j, st_j, kf_j = _run(JBundleSdf(cfg_track=small_track_cfg(), use_nof=False,
                                      out_dir=str(tmp_path)), data)
    assert kf_t == kf_j and st_t == st_j and jframe.FAIL not in st_t
    for a, b in zip(p_t.astype(np.float64), p_j.astype(np.float64)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3
        # angle from the chord: the arccos of the trace reads f32 rounding
        # of equal rotations as ~0.04 deg
        chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
        assert np.degrees(2 * np.arcsin(min(1.0, chord))) < 0.2
    res = metrics.trajectory_add_auc(p_t, data["gt_ob_in_cam"], cube_model_points(data["half"]))
    assert res["mean_add"] < 0.01, res
    counts = {k: v["count"] for k, v in tprof.stats().items()}
    assert counts["launch/fused_match_ba"] == N_FRAMES - 1
    assert "launch/ba" not in counts


N_SIFT_FRAMES = 4


def test_tracking_sift_matches_jax(data, tmp_path):
    """``feature_corres.matcher: sift`` in both packages (the port's device
    SIFT on the CPU against OpenCV's in the JAX engine) over the first
    frames, with the JAX key's RANSAC draws: poses within 1 mm and 0.5 deg,
    the same FAIL statuses (none) and keyframes.  RANSAC sees equal match
    sets, but rows tied in confidence may come in another order, so the
    bound is on poses, not bits (measured: within 3e-9 m and 4e-6 deg)."""
    from bundlesdf_tpu_torch.models.matcher import SiftMatcher
    from bundlesdf_tpu_torch.utils import profiler as tprof

    cfg = small_track_cfg()
    cfg["feature_corres"]["matcher"] = "sift"
    tprof.reset()
    out = []
    for tracker in (entry.build_tracker(port_cfg(cfg), device="cpu", ransac_draws=jax_draws),
                    JBundleSdf(cfg_track=cfg, use_nof=False, out_dir=str(tmp_path))):
        frames = [tracker.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                              mask=data["masks"][k]) for k in range(N_SIFT_FRAMES)]
        out.append((np.stack([tracker.poses_log[f"{k:04d}"] for k in range(N_SIFT_FRAMES)]),
                    [f.status for f in frames], [f.id for f in tracker.bundler.keyframes]))
        if not out[1:]:
            assert isinstance(tracker.bundler.store.matcher, SiftMatcher)
    (p_t, st_t, kf_t), (p_j, st_j, kf_j) = out
    assert st_t == st_j and kf_t == kf_j and jframe.FAIL not in st_t
    for a, b in zip(p_t.astype(np.float64), p_j.astype(np.float64)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3
        chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
        assert np.degrees(2 * np.arcsin(min(1.0, chord))) < 0.5
    counts = {k: v["count"] for k, v in tprof.stats().items()}
    assert counts["launch/corres"] >= N_SIFT_FRAMES - 1


def test_tracking_split_path_and_default_draws(data):
    """bundle.fused_ba False (the split find_corres + optimize path) and no
    draw source (a generator seeded with the frame id) still track the
    sequence to sub-cm ADD with no FAIL frames."""
    from bundlesdf_tpu_torch.utils import profiler as tprof

    cfg = port_cfg(small_track_cfg())
    cfg["bundle"]["fused_ba"] = False
    tprof.reset()
    poses, status, kfs = _run(entry.build_tracker(cfg, device="cpu"), data)
    assert jframe.FAIL not in status and kfs[0] == 0
    counts = {k: v["count"] for k, v in tprof.stats().items()}
    assert counts["launch/ba"] == N_FRAMES - 1 and "launch/fused_match_ba" not in counts
    res = metrics.trajectory_add_auc(poses, data["gt_ob_in_cam"], cube_model_points(data["half"]))
    assert res["mean_add"] < 0.01, res


def test_bundlesdf_surface():
    # use_nof=True (the default, as in JAX) is the joint loop; no NOF
    # runner exists before the first round
    j = entry.BundleSdf(device="cpu")
    assert j.use_nof is True and j.nof is None and j.start_nerf_keyframes == 5
    t = entry.build_tracker(device="cpu")
    assert t.cfg_track == default_track_config() and t.use_nof is False
    assert t.on_finish() is None


def test_gate_matches_3d_equals_jax(data):
    """The host 3D gate (the JAX package's host-warp path keeps it; the
    port's fused path gates on the device): equal tables, with rows out of
    bounds and on invalid depth."""
    from bundlesdf_tpu.tracking import corres as jcorres
    from bundlesdf_tpu_torch.tracking import corres as tcorres

    cfg = small_track_cfg()
    f = [(jframe.Frame(data["colors"][k], data["depths"][k], data["K"], k, str(k), cfg,
                       fg_mask=data["masks"][k]),
          tframe.Frame(data["colors"][k], data["depths"][k], data["K"], k, str(k),
                       port_cfg(cfg), fg_mask=data["masks"][k])) for k in (0, 1)]
    rng = np.random.default_rng(5)
    uvA = rng.uniform(-5, 100, (300, 2))
    uvB = uvA + rng.normal(0, 2, uvA.shape)
    ref = jcorres.gate_matches_3d(f[1][0], f[0][0], uvA, uvB, 256)
    out = tcorres.gate_matches_3d(f[1][1], f[0][1], uvA, uvB, 256)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert 0 < ref["valid"].sum() < 256


def test_feature_tracks_equal_jax():
    """Union-find tracks: covisible counts, propagation candidates (in
    order) and compaction after forgetting frames."""
    from bundlesdf_tpu.tracking.corres import FeatureTracks as JTracks
    from bundlesdf_tpu_torch.tracking.corres import FeatureTracks as TTracks

    rng = np.random.default_rng(6)
    tj, tt = JTracks(), TTracks()
    base = rng.integers(0, 300, (400, 2))
    for fa, fb in ((1, 0), (2, 1), (2, 0), (3, 2), (3, 1)):
        uvA = base + fa + rng.integers(-1, 2, base.shape)
        uvB = base + fb
        inl = rng.uniform(size=len(base)) < 0.7
        for t in (tj, tt):
            t.add_matches(fa, fb, uvA, uvB, inl)
    for a, b in ((3, 0), (2, 0), (3, 1), (1, 3)):
        assert tt.n_covisible(a, b) == tj.n_covisible(a, b)
        for x, y in zip(tt.propagate(a, b), tj.propagate(a, b)):
            np.testing.assert_array_equal(x, y)
    assert len(tt.propagate(3, 0)[0]) > 50
    for t in (tj, tt):
        t.forget_frame(0)
        t.forget_frame(1)
        t.compact()
    assert tt._parent == tj._parent
    np.testing.assert_array_equal(tt.propagate(3, 2)[0], tj.propagate(3, 2)[0])


def test_trajectory_metrics_equal_jax(data):
    from bundlesdf_tpu.utils import metrics as jmetrics

    rng = np.random.default_rng(7)
    gts = data["gt_ob_in_cam"].astype(np.float64)
    preds = gts.copy()
    preds[:, :3, 3] += rng.normal(0, 0.004, (len(gts), 3))
    pts = cube_model_points(data["half"])
    out = metrics.trajectory_add_auc(preds, gts, pts)
    ref = jmetrics.trajectory_add_auc(preds, gts, pts)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
