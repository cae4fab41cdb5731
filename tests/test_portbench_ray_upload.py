"""The per-layer metric ``ray_upload_mb_per_round``
(``portbench/metrics/ray_upload_mb_per_round.py``): the NOF runner's counter
``nof/pool_upload_bytes`` over the rounds (``nof/round_start``), reported in
the joint cell, and nothing where the program has no such counter."""
import os

import numpy as np

from synthetic import make_sphere_dataset
from test_nof import tiny_cfg
from bundlesdf_tpu_torch.config import Cfg
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.nof.render import RAY_DIM
from bundlesdf_tpu_torch.utils import profiler
from portbench import run as R

NAME = "ray_upload_mb_per_round"


def _read(run):
    reader = R._load_module(os.path.join(R.BENCH_DIR, "metrics", f"{NAME}.py"),
                            "portbench_metric_" + NAME)
    return reader.read(run)


def test_reported_in_the_joint_cell_alone():
    for cell in ("online.joint_video", "online.nof_train", "online.track_only"):
        names = [m["name"] for m in R.plan(cell)["per_layer"]]
        assert (NAME in names) == (cell == "online.joint_video"), cell


def test_nothing_to_read_without_the_counter():
    rounds = {"nof/round_start": {"count": 3, "total_s": 1.0}}
    assert _read({"record": {"spans": rounds}}) is None
    assert _read({"record": {"spans": {"nof/pool_upload_bytes": {"count": 5}}}}) is None
    assert _read({"record": {}}) is None


def test_the_runner_bytes_over_its_rounds():
    """Two rounds of one new frame each, under ``nof/round_start`` as the
    loop opens them: the metric is the new rows' bytes over the two."""
    data = make_sphere_dataset(n_views=3, H=32, W=32)
    cfg = Cfg.wrap(dict(tiny_cfg()))
    runner = trunner.NofRunner(cfg, data["images"][:1], data["depths"][:1],
                               data["masks"][:1], data["poses"][:1], data["K"],
                               data["cloud"], device="cpu")
    profiler.reset()
    n0 = runner.n_rays
    for k in (1, 2):
        with profiler.span("nof/round_start"):
            runner.add_new_frames(data["images"][k:k + 1], data["depths"][k:k + 1],
                                  data["masks"][k:k + 1], data["poses"][:k + 1],
                                  data["cloud"])
    assert runner.n_rays > n0
    value = _read({"record": {"spans": profiler.stats()}})
    assert value == (runner.n_rays - n0) * RAY_DIM * 4 / 1e6 / 2
    assert "nof/pool_subsample" not in profiler.stats()
    assert np.isfinite(value) and value > 0
