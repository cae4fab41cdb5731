"""``run_custom --mode run_video`` under ``BSDF_*`` with 2 gloo ranks on the
CPU (``tests/port_dp_worker.py``): rank 0 reads the video, tracks and
writes the artifact trail, rank 1 trains the NOF with it and writes
nothing; ``entry.run_global_refine`` then loads the trail."""
import os
import sys

import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg
from bundlesdf_tpu_torch.io.png import write_png
from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

sys.path.insert(0, os.path.dirname(__file__))
from port_dp_worker import start_ranks  # noqa: E402
from synthetic_cube import make_cube_sequence  # noqa: E402
from test_torch_joint_dp import plain, small_nof, small_track  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 5


def write_cube_video(folder, n):
    """The cube frames in the YCBInEOAT layout (rgb/ depth/ masks/ cam_K.txt)."""
    data = make_cube_sequence(n_frames=n, deg_per_frame=3.0)
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for k in range(n):
        name = f"{k:05d}.png"
        write_png(os.path.join(folder, "rgb", name), data["colors"][k].astype(np.uint8))
        write_png(os.path.join(folder, "depth", name),
                  np.round(data["depths"][k] * 1000).astype(np.uint16))
        write_png(os.path.join(folder, "masks", name),
                  (data["masks"][k] > 0).astype(np.uint8) * 255)
    np.savetxt(os.path.join(folder, "cam_K.txt"), data["K"])


def test_run_video_under_bsdf_tracks_on_rank0_and_refines(tmp_path, monkeypatch):
    vdir = str(tmp_path / "video")
    out = f"{vdir}/out"
    write_cube_video(vdir, N_FRAMES)
    inp = {"track": plain(small_track()), "nof": plain(small_nof()),
           "argv": ["--mode", "run_video", "--video_dir", vdir, "--out_folder", out,
                    "--debug_level", "2", "--shorter_side", "96", "--device", "cpu"]}
    r0, r1 = start_ranks("run_video", 2, inp, tmp_path / "ranks", timeout=150)()
    assert r0["lead"] and r0["bundler"] and not r1["lead"] and not r1["bundler"]
    assert r0["steps"] == r1["steps"] > 0
    assert r1["wrote"] == []
    wrote = {os.path.relpath(p, out) for p in r0["wrote"]}
    for name in ("config_track.yml", "config_nerf.yml", "keyframes.yml", "mesh_online.obj",
                 *(f"ob_in_cam/{k:05d}.txt" for k in range(N_FRAMES))):
        assert name in wrote, name
    assert any(p.startswith("color_segmented/") for p in wrote)

    # the offline refinement restarts from rank 0's trail (small budget:
    # the plumbing is under test)
    seen = {}
    orig = BundleSdf.run_global_nerf

    def small(self, frames_data, cfg_refine=None, get_texture=False):
        seen.update(n=len(frames_data), sc=self.sc_factor)
        return orig(self, frames_data, Cfg.wrap(dict(cfg_refine.merged(small_nof()),
                                                     n_step=cfg_refine["n_step"])),
                    get_texture)

    monkeypatch.setattr(BundleSdf, "run_global_nerf", small)
    pipe, mesh, poses = entry.run_global_refine(out, refine_steps=5, get_texture=False,
                                                device="cpu")
    saved = Cfg.load(f"{out}/config_nerf.yml")
    assert seen["n"] == len(poses) >= 3 and seen["sc"] == pytest.approx(saved["sc_factor"])
    assert pipe.global_nof.total_step == 5
    assert os.path.exists(f"{out}/textured_mesh.obj")
    assert os.path.exists(f"{out}/poses_after_global_refine.txt")
