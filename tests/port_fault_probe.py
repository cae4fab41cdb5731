"""One-off CPU measurements of two questions about the port against the JAX
package (not a test: pytest does not collect this file).

    JAX_PLATFORMS=cpu python tests/port_fault_probe.py wobble
    JAX_PLATFORMS=cpu python tests/port_fault_probe.py joint [H W]

``wobble``: the tracking-only tracker of both packages under the shipped
tracker config on ``chip_smoke.py``'s 16-frame 480 x 640 dots-cube video at
full translation wobble (``TRACK_WOBBLE`` 1.0); prints each package's FAIL
frames and mean ADD.  The port gets the JAX key's RANSAC draws.

``joint``: the same video cut to ``chip_smoke.JOINT_FRAMES`` frames at
H x W (default 240 x 320, focal length scaled with the width), tracking only
and joint (the shipped NOF config cut to ``chip_smoke.JOINT_DEPTH``, NOF
rounds from the ``JOINT_START``-th keyframe), in both packages; the port
gets the JAX key's RANSAC draws, the JAX init's weights and the rays the JAX
steps drew (``tests/test_torch_pipeline.py``).  Prints mean ADD of each of
the four runs.
"""
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from synthetic_cube import cube_model_points  # noqa: E402
from test_torch_pipeline import JaxBatches, jax_draws, jax_init  # noqa: E402
from bundlesdf_tpu.config import default_nof_config as jax_nof_config  # noqa: E402
from bundlesdf_tpu.config import default_track_config as jax_track_config  # noqa: E402
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf  # noqa: E402
from bundlesdf_tpu_torch import entry  # noqa: E402
from bundlesdf_tpu_torch.config import default_nof_config, default_track_config  # noqa: E402
from bundlesdf_tpu_torch.nof import runner as trunner  # noqa: E402
from bundlesdf_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(4)


def run(pipe, video, n):
    status = [pipe.run(video["colors"][k], video["depths"][k], video["K"], f"{k:05d}",
                       mask=video["masks"][k]).status for k in range(n)]
    if getattr(pipe, "use_nof", False):
        pipe.on_finish()
    preds = np.stack([pipe.poses_log[f"{k:05d}"] for k in range(n)])
    res = metrics.trajectory_add_auc(preds, np.stack(video["gt"][:n]), video["model_pts"])
    return {"fail_frames": [k for k, s in enumerate(status) if s == 1],
            "mean_add_m": res["mean_add"], "max_add_m": float(res["add_errs"].max()),
            "keyframes": [f.id for f in pipe.bundler.keyframes]}


def wobble():
    n = chip_smoke.TRACK_FRAMES
    H, W = chip_smoke.TRACK_HW
    video = chip_smoke.synth_video(n, H, W, chip_smoke.TRACK_DEG, wobble=1.0)
    with tempfile.TemporaryDirectory() as tmp:
        jax_res = run(JBundleSdf(cfg_track=jax_track_config(), use_nof=False, out_dir=tmp),
                      video, n)
    print(json.dumps({"wobble": 1.0, "package": "jax", **jax_res}), flush=True)
    port = entry.build_tracker(default_track_config(), device="cpu", ransac_draws=jax_draws)
    print(json.dumps({"wobble": 1.0, "package": "port", **run(port, video, n)}), flush=True)


def joint(H=240, W=320):
    n = chip_smoke.JOINT_FRAMES
    video = chip_smoke.synth_video(n, H, W, chip_smoke.TRACK_DEG, f=600.0 * W / 640)
    video["model_pts"] = cube_model_points(0.15)
    start = chip_smoke.JOINT_START
    with tempfile.TemporaryDirectory() as tmp:
        jt = run(JBundleSdf(cfg_track=jax_track_config(), use_nof=False, out_dir=tmp),
                 video, n)
        print(json.dumps({"hw": [H, W], "package": "jax", "mode": "tracking", **jt}),
              flush=True)
        cfg = jax_nof_config()
        cfg.update(chip_smoke.JOINT_DEPTH)
        with pytest.MonkeyPatch.context() as mp:
            batches = JaxBatches(mp)
            jpipe = JBundleSdf(cfg_track=jax_track_config(), cfg_nof=cfg, use_nof=True,
                               start_nerf_keyframes=start, out_dir=tmp)
            jj = run(jpipe, video, n)
            print(json.dumps({"hw": [H, W], "package": "jax", "mode": "joint",
                              "steps": jpipe.nof.total_step, **jj}), flush=True)
            pt = run(entry.build_tracker(default_track_config(), device="cpu",
                                         ransac_draws=jax_draws), video, n)
            print(json.dumps({"hw": [H, W], "package": "port", "mode": "tracking", **pt}),
                  flush=True)
            mp.setattr(trunner.nof_model, "init_nof_params", jax_init)
            cfg = default_nof_config()
            cfg.update(chip_smoke.JOINT_DEPTH)
            pipe = entry.build_pipeline(default_track_config(), cfg,
                                        start_nerf_keyframes=start, device="cpu",
                                        ransac_draws=jax_draws, nof_draws=batches)
            batches.pipe = pipe
            pj = run(pipe, video, n)
            print(json.dumps({"hw": [H, W], "package": "port", "mode": "joint",
                              "steps": pipe.nof.total_step, "ray_misses": batches.misses,
                              "rays_replayed": batches.k, **pj}), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "wobble":
        wobble()
    else:
        joint(*(int(a) for a in sys.argv[2:4]))
