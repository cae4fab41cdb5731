"""``bundlesdf_tpu_torch.scripts.make_synth_video`` against the JAX
harness's ``scripts/make_synth_video.py`` on the same arguments: the port
runs as ``python3 -m`` with cv2, PIL and imageio blocked; every frame's
decoded arrays equal (cv2 reads both; the PNG bytes may differ),
``cam_K.txt`` equal as text and the poses equal."""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("args", [["3", "9.0"], ["2"]])
def test_make_synth_video_matches_jax_script(tmp_path, args):
    ref, port = str(tmp_path / "jax"), str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "scripts/make_synth_video.py", ref, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    blocked = ("import runpy, sys\n"
               "for m in ('jax', 'cv2', 'PIL', 'imageio'): sys.modules[m] = None\n"
               "runpy.run_module('bundlesdf_tpu_torch.scripts.make_synth_video', "
               "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", blocked, port, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(args[0])
    for sub in ("rgb", "depth", "masks"):
        names = sorted(os.listdir(os.path.join(ref, sub)))
        assert names == sorted(os.listdir(os.path.join(port, sub)))
        assert len(names) == n
        for name in names:
            a = cv2.imread(os.path.join(port, sub, name), -1)
            b = cv2.imread(os.path.join(ref, sub, name), -1)
            assert a.dtype == b.dtype and np.array_equal(a, b), (sub, name)
    for sub in ("rgb", "masks"):  # the frames are not blank
        assert cv2.imread(os.path.join(port, sub, "00000.png"), -1).max() > 0
    with open(os.path.join(ref, "cam_K.txt")) as f, open(os.path.join(port, "cam_K.txt")) as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(np.load(os.path.join(port, "gt_ob_in_cam.npy")),
                                  np.load(os.path.join(ref, "gt_ob_in_cam.npy")))
