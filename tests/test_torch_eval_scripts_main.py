"""The port's ``benchmark_synth`` and ``benchmark_long`` mains on a tiny CPU
run (3 frames of the hard fixture at 240 x 240, read at that size, the NOF
at the small budget of tests/test_pipeline.py::small_nof_cfg) write their
reports with the JAX scripts' keys (``benchmark_long`` less
``n_train_program_shapes``, an XLA compile count).  The JAX
``benchmark_synth`` main assembles its report from the port's run (its
``run_engine`` handed the port's result) and its own ``evaluate``."""
import json
import os
import shutil
import sys

import pytest
import torch

from bundlesdf_tpu_torch.config import Cfg, default_nof_config
from bundlesdf_tpu_torch.io.readers import YcbineoatReader
from bundlesdf_tpu_torch.scripts import benchmark_long as tlong
from bundlesdf_tpu_torch.scripts import benchmark_synth as tsynth
from bundlesdf_tpu_torch.scripts import synth_hard as thard
from test_pipeline import small_nof_cfg

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import benchmark_synth as jsynth  # noqa: E402  (the JAX script)

torch.set_num_threads(2)

# the keys of the JAX benchmark_long report (scripts/benchmark_long.py:
# 142-153, 200-212) that the port keeps
LONG_KEYS = {"n_frames", "ADD_AUC", "ADDS_AUC", "mean_ADD_cm", "mean_ADDS_cm", "wall_s",
             "fps", "n_tracking_fail", "peak_rss_gb", "ray_pool_caps", "kf_pool_over_time",
             "kf_pool_final", "tracks_parent_final", "tracks_parent_max", "rss_curve"}
LONG_FIXTURE = {"frames", "deg_per_frame", "total_rotation_deg", "occluder",
                "sync_max_delay", "n_step_extend"}
# the JAX benchmark_synth profile's own keys and its overlap windows'
# (scripts/benchmark_synth.py:150-194)
PROFILE_KEYS = {"overlap", "overlap_warm", "launches_per_frame", "readbacks_per_frame"}
OVERLAP_KEYS = {"nof_steps", "nof_step_ms", "nof_device_s", "blocked_wait_s", "overlap_frac",
                "wall_minus_nof_device_s"}
TINY = ["--frames", "3", "--skip_gen"]


def small_port_nof():
    return Cfg.wrap(default_nof_config().merged(small_nof_cfg()))


@pytest.fixture(autouse=True)
def read_at_240(monkeypatch):
    """The scripts read the fixture at its own 240 x 240 (they ask for 480)."""
    def reader(video_dir, shorter_side):
        return YcbineoatReader(video_dir, shorter_side=240)

    for mod in (tsynth, tlong):
        monkeypatch.setattr(mod, "YcbineoatReader", reader)


def keys(d, depth=2):
    """The report's key tree to ``depth`` (the profile's span names are
    each package's own)."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: keys(v, depth - 1) for k, v in d.items() if k not in ("profile", "video")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    thard.make_hard_video(str(root / "port" / "video"), n_frames=3, H=240, W=240)
    shutil.copytree(root / "port" / "video", root / "jax" / "video")
    return root


def test_benchmark_synth_main_has_the_jax_keys(tiny, monkeypatch):
    monkeypatch.setattr(tsynth, "default_nof_config", small_port_nof)
    runs = []
    run_engine = tsynth.run_engine

    def recording(*a, **k):
        runs.append(run_engine(*a, **k))
        return runs[-1]

    monkeypatch.setattr(tsynth, "run_engine", recording)
    port = tsynth.main(["--matchers", "corner", "--workdir", str(tiny / "port"),
                        "--device", "cpu", *TINY])
    with open(tiny / "port" / "EVAL_synth.json") as f:
        assert json.load(f) == json.loads(json.dumps(port))
    prof = port["corner"]["profile"]
    assert PROFILE_KEYS <= set(prof) and set(prof["overlap"]) == OVERLAP_KEYS
    assert set(prof["overlap_warm"]) == OVERLAP_KEYS | {"launches_per_frame",
                                                         "readbacks_per_frame"}
    assert port["corner"]["n_frames"] == 3 and port["corner"]["n_tracking_fail"] == 0

    shutil.copytree(tiny / "port" / "out_corner", tiny / "jax" / "out_corner")
    monkeypatch.setattr(jsynth, "run_engine", lambda *a, **k: runs[0])
    out = str(tiny / "jax" / "EVAL_synth.json")
    monkeypatch.setattr(sys, "argv", ["benchmark_synth.py", "--matchers", "corner",
                                      "--frames", "3", "--skip_gen", "--workdir",
                                      str(tiny / "jax"), "--out", out])
    jsynth.main()
    with open(out) as f:
        ref = json.load(f)
    assert keys(port, 3) == keys(ref, 3)
    assert {k: v for k, v in port["corner"].items() if k != "profile"} == \
        {k: v for k, v in ref["corner"].items() if k != "profile"}


def test_benchmark_long_main_has_the_jax_keys(tiny, monkeypatch):
    monkeypatch.setattr(tlong, "default_nof_config", small_port_nof)
    rep = tlong.main(["--workdir", str(tiny / "port"), "--device", "cpu", *TINY])
    with open(tiny / "port" / "EVAL_long.json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert set(rep) == {"fixture", "corner"} and set(rep["fixture"]) == LONG_FIXTURE
    assert set(rep["corner"]) == LONG_KEYS
    assert rep["corner"]["n_frames"] == 3 and rep["corner"]["kf_pool_final"] >= 1
    assert {"frame", "rss_gb", "unattributed", "frames",
            "match_tables"} <= set(rep["corner"]["rss_curve"][-1])
