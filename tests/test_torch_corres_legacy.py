"""The port's host-warp correspondence path (``tracking/corres.py::
_find_corres_legacy``, ``process_image_pair``) against the JAX package, with
the behaviours of tests/test_corres_reuse.py: the 3-frame cube fixture of
tests/test_torch_fused.py under ``feature_corres.fused: False``, the JAX
key's RANSAC draws, and the tracker through the host-warp path on the cube
sequence of tests/test_torch_tracker.py.

The warps are bit-equal to cv2's (so the two corner matchers see the same
crops); the JAX matcher is jitted whole, so ZNCC confidences within 1e-5
may swap rows, and tables are compared keyed by their pixels or sorted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_cube import cube_model_points, make_cube_sequence
from test_pipeline import small_track_cfg
from bundlesdf_tpu.config import default_track_config as jax_track_cfg
from bundlesdf_tpu.models import matcher as jmatcher
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf
from bundlesdf_tpu.tracking import corres as jcorres
from bundlesdf_tpu.tracking.frame import FAIL
from bundlesdf_tpu.tracking.frame import Frame as JFrame
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_track_config
from bundlesdf_tpu_torch.models import matcher as tmatcher
from bundlesdf_tpu_torch.tracking import corres as tcorres
from bundlesdf_tpu_torch.tracking.frame import Frame as TFrame
from bundlesdf_tpu_torch.utils import metrics
from bundlesdf_tpu_torch.utils import profiler as tprof

torch.set_num_threads(2)
H = W = 96
SMALL = {"feature_corres": {"resize": 160, "max_matches_per_pair": 256},
         "ransac": {"max_iter": 256}, "bundle": {"max_BA_frames": 5},
         "depth_processing": {"percentile": 100}}


def jax_draws(seed, shape):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


def _cfgs(**fc):
    cj, ct = jax_track_cfg().merged(SMALL), default_track_config().merged(SMALL)
    for c in (cj, ct):
        c["feature_corres"]["fused"] = False
        c["feature_corres"].update(fc)
    return cj, ct


@pytest.fixture(scope="module")
def frames():
    """3 frames of the 96 x 96 cube sequence, 4 deg apart, at their true
    poses, in both packages."""
    cfg_j, cfg_t = _cfgs()
    data = make_cube_sequence(n_frames=3, H=H, W=W, deg_per_frame=4.0)
    fj, ft = [], []
    for k in range(3):
        for cls, cfg, out in ((JFrame, cfg_j, fj), (TFrame, cfg_t, ft)):
            f = cls(data["colors"][k], data["depths"][k], data["K"], id=k,
                    id_str=f"{k:05d}", cfg=cfg, fg_mask=data["masks"][k] > 0)
            f.pose_in_model = np.linalg.inv(data["gt_ob_in_cam"][k]).astype(np.float32)
            out.append(f)
    return fj, ft


def _keyed(m, fields=("valid", "pA", "pB")):
    rows = {}
    for r in np.nonzero(np.any(m["uvA"] != 0, axis=-1) | m["valid"])[0]:
        key = tuple(m["uvA"][r]) + tuple(m["uvB"][r])
        rows[key] = tuple(np.asarray(m[f][r]).tobytes() for f in fields)
    return rows


def _sorted(raw):
    return raw[np.lexsort(raw.T)]


def test_process_image_pair_matches_jax(frames):
    """The host warp: homographies equal, crops bit-equal to cv2's."""
    fj, ft = frames
    a_j, b_j, ta_j, tb_j = jcorres.process_image_pair(fj[2], fj[0], 160)
    a_t, b_t, ta_t, tb_t = tcorres.process_image_pair(ft[2], ft[0], 160, device="cpu")
    np.testing.assert_array_equal(ta_t, ta_j)
    np.testing.assert_array_equal(tb_t, tb_j)
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    np.testing.assert_array_equal(b_t.numpy(), b_j)
    assert a_t.dtype == torch.float32 and a_t.shape == (160, 160) and b_j.max() > 50
    uv = np.array([[3.5, 7.0], [90.0, 12.25]])
    np.testing.assert_array_equal(tcorres._apply_homography(ta_t, uv),
                                  jcorres._apply_homography(ta_j, uv))


class Spy:
    """A matcher_fn that counts its calls and batch sizes and runs the
    package's corner matcher on the crops."""

    def __init__(self, jax_side: bool):
        self.jax_side, self.sizes = jax_side, []

    def __call__(self, imgsA, imgsB):
        self.sizes.append(len(imgsA))
        if self.jax_side:
            res = jmatcher.match_pairs_batched(jnp.asarray(imgsA), jnp.asarray(imgsB),
                                               jmatcher.CornerMatcherCfg(max_matches=256))
            return np.asarray(res["corres"]), np.asarray(res["valid"])
        assert torch.is_tensor(imgsA) and imgsA.dtype == torch.float32
        res = tmatcher.match_pairs_batched(imgsA, imgsB,
                                           tmatcher.CornerMatcherCfg(max_matches=256))
        return res["corres"], res["valid"]


def _both(frames, pairs_idx, seed, spy=False, **fc):
    fj, ft = frames
    cfg_j, cfg_t = _cfgs(**fc)
    sj, st = jcorres.CorresStore(cfg_j), tcorres.CorresStore(cfg_t, device="cpu")
    spies = (Spy(True), Spy(False)) if spy else (None, None)
    jcorres.find_corres(sj, [(fj[a], fj[b]) for a, b in pairs_idx], cfg_j,
                        key=jax.random.PRNGKey(seed), matcher_fn=spies[0])
    tcorres.find_corres(st, [(ft[a], ft[b]) for a, b in pairs_idx], cfg_t, key=seed,
                        ransac_draws=jax_draws, matcher_fn=spies[1])
    return sj, st, spies


def _assert_tables_equal(sj, st, pairs_idx, min_inliers=10):
    for a, b in pairs_idx:
        rt, rj = st.raw[(a, b)], sj.raw[(a, b)]
        assert rt.shape == rj.shape and len(rt) > 20
        np.testing.assert_allclose(_sorted(rt), _sorted(rj), rtol=0, atol=1e-3)
        mt, mj = st.matches[(a, b)], sj.matches[(a, b)]
        assert _keyed(mt) == _keyed(mj)
        assert mt["inlier"].sum() == mj["inlier"].sum() >= min_inliers, (a, b)
        assert _keyed(mt, ("inlier",)) == _keyed(mj, ("inlier",))


@pytest.mark.parametrize("spy", [False, True], ids=["engine", "matcher_fn"])
@pytest.mark.parametrize("pairs_idx", [[(1, 0)], [(1, 0), (2, 0), (2, 1)]])
def test_legacy_find_corres_matches_jax(frames, pairs_idx, spy):
    """One pair (bucket 1) and 3 pairs (bucket pair_batch = 16) through the
    host-warp path, with the corner engine or a matcher_fn: raw tables within
    1e-3 px, gates and inliers equal, the same matcher batches."""
    sj, st, spies = _both(frames, pairs_idx, 4, spy)
    _assert_tables_equal(sj, st, pairs_idx)
    if spy:
        assert spies[1].sizes == spies[0].sizes == [1 if len(pairs_idx) == 1 else 16]
    fj, ft = frames
    for a, b in pairs_idx:
        np.testing.assert_allclose(tcorres.procrustes_offset(st, ft[a], ft[b]),
                                   jcorres.procrustes_offset(sj, fj[a], fj[b]), rtol=0,
                                   atol=1e-5)


def test_pair_batch_buckets(frames):
    """tests/test_corres_reuse.py::test_pair_batch_buckets on the port:
    pair_batch 4 pads one fresh pair to 1 and three to 4, the RANSAC draws
    take the same bucket, and a host engine (compiled = False) runs the
    pairs unpadded."""
    _, ft = frames
    _, cfg = _cfgs(pair_batch=4)
    shapes = []

    def draws(seed, shape):
        shapes.append(shape)
        return jax_draws(seed, shape)

    spy = Spy(False)
    tcorres.find_corres(tcorres.CorresStore(cfg, device="cpu"), [(ft[1], ft[0])], cfg,
                        matcher_fn=spy, ransac_draws=draws)
    assert spy.sizes[-1] == 1 and shapes[-1] == (1, 256, 3)
    tcorres.find_corres(tcorres.CorresStore(cfg, device="cpu"),
                        [(ft[1], ft[0]), (ft[2], ft[0]), (ft[2], ft[1])], cfg,
                        matcher_fn=spy, ransac_draws=draws)
    assert spy.sizes[-1] == 4 and shapes[-1] == (4, 256, 3)

    class HostSpy:
        compiled = False

        def __init__(self):
            self.sizes = []

        def predict(self, imgsA, imgsB):
            self.sizes.append(len(imgsA))
            B = len(imgsA)
            return np.zeros((B, 256, 5), np.float32), np.zeros((B, 256), bool)

    store = tcorres.CorresStore(cfg, device="cpu")
    store.matcher = HostSpy()
    assert not store.use_fused
    tcorres.find_corres(store, [(ft[1], ft[0]), (ft[2], ft[0]), (ft[2], ft[1])], cfg)
    assert store.matcher.sizes == [3]


def test_raw_reuse_regates_without_matcher(frames):
    """After a match invalidation the raw table is re-gated under moved
    poses without the matcher (launch/corres unchanged, launch/ransac + 1),
    equal to the JAX package's re-gate."""
    fj, ft = frames
    sj, st, spies = _both(frames, [(1, 0)], 2, spy=True)
    for s in (sj, st):
        s.invalidate_matches(1)
        assert (1, 0) in s.raw and (1, 0) not in s.matches
    moved = []
    for f in (fj[1], ft[1]):
        old = f.pose_in_model
        f.pose_in_model = old.copy()
        f.pose_in_model[:3, 3] += np.float32(0.003)
        moved.append((f, old))
    try:
        cfg_j, cfg_t = _cfgs()
        tprof.reset()
        jcorres.find_corres(sj, [(fj[1], fj[0])], cfg_j, key=jax.random.PRNGKey(5),
                            matcher_fn=spies[0])
        tcorres.find_corres(st, [(ft[1], ft[0])], cfg_t, key=5, ransac_draws=jax_draws,
                            matcher_fn=spies[1])
        counts = {k: v["count"] for k, v in tprof.stats().items()}
        assert spies[0].sizes == spies[1].sizes == [1]  # the first match only
        assert "launch/corres" not in counts and counts["launch/ransac"] == 1
        _assert_tables_equal(sj, st, [(1, 0)], min_inliers=5)
    finally:
        for f, old in moved:
            f.pose_in_model = old


def test_track_propagation_feeds_ransac_candidates(frames):
    """tests/test_corres_reuse.py::test_track_propagation_feeds_ransac_
    candidates on the port, against the JAX run: a pair whose matcher
    returns nothing is matched from the tracks through frame 1 alone."""
    fj, ft = frames
    sj, st, _ = _both(frames, [(1, 0)], 1)
    cfg_j, cfg_t = _cfgs()
    jcorres.find_corres(sj, [(fj[2], fj[1])], cfg_j, key=jax.random.PRNGKey(2))
    tcorres.find_corres(st, [(ft[2], ft[1])], cfg_t, key=2, ransac_draws=jax_draws)
    for a, b in zip(st.tracks.propagate(2, 0), sj.tracks.propagate(2, 0)):
        np.testing.assert_array_equal(a, b)
    assert len(st.tracks.propagate(2, 0)[0]) > 0

    def empty(imgsA, imgsB):
        B = len(imgsA)
        return np.zeros((B, 256, 5), np.float32), np.zeros((B, 256), bool)

    jcorres.find_corres(sj, [(fj[2], fj[0])], cfg_j, key=jax.random.PRNGKey(3), matcher_fn=empty)
    tcorres.find_corres(st, [(ft[2], ft[0])], cfg_t, key=3, ransac_draws=jax_draws,
                        matcher_fn=empty)
    np.testing.assert_array_equal(st.raw[(2, 0)], sj.raw[(2, 0)])
    assert st.n_inliers((2, 0)) == sj.n_inliers((2, 0)) >= 3


def _run(tracker, data, n):
    frames = [tracker.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                          mask=data["masks"][k]) for k in range(n)]
    return (np.stack([tracker.poses_log[f"{k:04d}"] for k in range(n)]),
            [f.status for f in frames], [f.id for f in tracker.bundler.keyframes])


def test_tracker_host_warp_path_matches_jax(tmp_path):
    """The tracker under ``feature_corres.fused: False``: the corner matcher
    through the host-warp path and the split BA in both packages (the JAX
    key's RANSAC draws).  Poses within 1 mm and 0.2 deg, the same keyframes
    and statuses, sub-cm mean ADD; one BA a frame and no fused program."""
    n = 6
    data = make_cube_sequence(n_frames=n, deg_per_frame=3.0)
    cfg = small_track_cfg()
    cfg["feature_corres"]["fused"] = False
    tprof.reset()
    tracker = entry.build_tracker(Cfg.wrap(default_track_config().merged(cfg)), device="cpu",
                                  ransac_draws=jax_draws)
    assert not tracker.bundler.store.use_fused and tracker.bundler.store.matcher is None
    p_t, st_t, kf_t = _run(tracker, data, n)
    counts = {k: v["count"] for k, v in tprof.stats().items()}
    p_j, st_j, kf_j = _run(JBundleSdf(cfg_track=cfg, use_nof=False, out_dir=str(tmp_path)),
                           data, n)
    assert kf_t == kf_j and st_t == st_j and FAIL not in st_t
    for a, b in zip(p_t.astype(np.float64), p_j.astype(np.float64)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3
        chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
        assert np.degrees(2 * np.arcsin(min(1.0, chord))) < 0.2
    assert counts["launch/ba"] == n - 1 and "launch/fused_match_ba" not in counts
    assert counts["launch/corres"] >= n - 1 and counts["launch/ransac"] == counts["launch/corres"]
    res = metrics.trajectory_add_auc(p_t, data["gt_ob_in_cam"], cube_model_points(data["half"]))
    assert res["mean_add"] < 0.01, res
