"""The correspondence path's spans and counters (``utils/profiler.py``):
``find_corres`` with a LoFTR engine records ``loftr/*`` under
``corres/match`` and counts the fresh pairs, the bucket's slots and the
valid matches; the corner matcher's fused path records what it recorded
before LoFTR had spans, with the same poses.

LoFTR runs at the narrow config of tests/test_torch_loftr.py on the CPU,
on the 96 x 96 cube sequence at true poses."""
import json

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from synthetic_cube import make_cube_sequence
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_track_config
from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.tracking import corres
from bundlesdf_tpu_torch.tracking.frame import Frame
from bundlesdf_tpu_torch.utils import profiler

torch.set_num_threads(2)
NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4,
              thr=0.0, max_matches=48)
SMALL = {"feature_corres": {"resize": 160, "max_matches_per_pair": 256},
         "ransac": {"max_iter": 512}, "bundle": {"max_BA_frames": 5, "image_downscale": 4},
         "depth_processing": {"percentile": 100}}
# The corner tracker (fused match + BA) over 6 cube frames at 3 degrees: its
# spans and counters, and each frame's ob_in_cam as (translation m,
# rotation vector rad), as the tree before LoFTR's spans recorded them.
CORNER_COUNTS = json.loads(
    '{"corres/match": 5, "corres/pool_upload": 10, "corres/warp": 10, "launch/corres": 5, '
    '"launch/fused_match_ba": 5, "launch/pool_upload": 6, "pipeline/run": 6, '
    '"readback/corres": 5, "readback/fused_match_ba": 5, "track/covisibility": 6, '
    '"track/depth/bilateral": 6, "track/depth/cloud": 6, "track/depth/erode": 6, '
    '"track/find_corres_ref": 5, "track/fused_match_ba": 5, "track/fused_pack": 5, '
    '"track/make_frame": 6, "track/process_new_frame": 6, "track/select_keyframes": 5}')
CORNER_POSES = [
    [0.0, 0.0, 0.39998, 0.0, 0.0, 0.0],
    [-0.00818, 0.000375, 0.400203, -2.2e-05, 0.051291, 0.01128],
    [-0.014708, -6.1e-05, 0.400701, 0.00011, 0.102616, 0.022242],
    [-0.022737, -9.6e-05, 0.401711, -0.000225, 0.153823, 0.027401],
    [-0.030011, -0.001222, 0.403017, 9.9e-05, 0.205189, 0.041516],
    [-0.037074, -0.000744, 0.404637, -0.00019, 0.256485, 0.049612]]


def test_loftr_spans_and_counters_under_corres_match():
    """A batch-1 call and a call of 3 fresh pairs in a bucket of 4: the four
    ``loftr/*`` spans once a call under ``corres/match``, ``corres/pairs``
    4 and ``corres/slots`` 5 (the batches the module ran), ``launch/loftr``
    2 (the module global too) and ``loftr/valid`` the valid matches the
    engine returned."""
    cfg = Cfg.wrap(default_track_config().merged(SMALL))
    cfg["feature_corres"]["pair_batch"] = 4
    data = make_cube_sequence(n_frames=4, deg_per_frame=3.0)
    frames = [Frame(data["colors"][k], data["depths"][k], data["K"], k, f"{k:04d}", cfg,
                    pose_in_model=np.linalg.inv(data["gt_ob_in_cam"][k]).astype(np.float32),
                    fg_mask=data["masks"][k], device="cpu") for k in range(4)]
    store = corres.CorresStore(cfg, "cpu")
    store.matcher = lt.LoftrMatcher(lt.LoftrCfg(**NARROW), seed=1, device="cpu")
    batches, valid = [], []
    forward, predict = store.matcher.module.forward, store.matcher.predict

    def spy_forward(img0, img1, gt_ids=None):
        batches.append(img0.shape[0])
        return forward(img0, img1, gt_ids)

    def spy_predict(a, b):
        out = predict(a, b)
        valid.append(int(out[1].sum()))
        return out

    store.matcher.module.forward = spy_forward
    store.matcher.predict = spy_predict
    profiler.enable(True)
    profiler.reset()
    before = lt.launches
    f = frames
    corres.find_corres(store, [(f[1], f[0])], cfg, key=1)
    corres.find_corres(store, [(f[3], f[0]), (f[3], f[1]), (f[3], f[2])], cfg, key=3)
    st = profiler.stats()
    assert batches == [1, 4]
    for name in ("loftr/backbone", "loftr/coarse", "loftr/fine", "loftr/readback"):
        assert st[name]["parents"] == {"corres/match": 2}, name
        assert st[name]["total_s"] > 0
    assert st["corres/pairs"]["count"] == 4
    assert st["corres/slots"]["count"] == sum(batches) == 5
    assert st["launch/loftr"]["count"] == lt.launches - before == 2
    assert sum(valid) > 0
    assert st["loftr/valid"]["count"] == sum(valid)


def test_corner_path_counters_and_poses_unchanged():
    """The corner matcher's fused path records none of the new counters:
    its spans and counts, and its poses (to 1e-5), are those it had."""
    cfg = Cfg.wrap(default_track_config().merged(SMALL))
    data = make_cube_sequence(n_frames=6, deg_per_frame=3.0)
    tracker = entry.build_tracker(cfg, device="cpu")
    assert tracker.bundler.store.use_fused
    profiler.enable(True)
    profiler.reset()
    for k in range(6):
        tracker.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                    mask=data["masks"][k])
    assert {k: v["count"] for k, v in profiler.stats().items()} == CORNER_COUNTS
    for k, want in enumerate(CORNER_POSES):
        p = tracker.poses_log[f"{k:04d}"].astype(np.float64)
        got = np.r_[p[:3, 3], Rotation.from_matrix(p[:3, :3]).as_rotvec()]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
