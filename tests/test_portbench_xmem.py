"""The benchmark's ``xmem_segment`` driver (``portbench/drivers/
xmem_segment.py``) on the CPU at a tiny size, in the manner of
``portbench/tests/tiny.py``: the published widths on 64 x 96 frames, the
memory schedule shrunk (``mem_every`` 1, T_min 2, T_max 3, LT_max 48, P 8)
so that a 12-frame session consolidates and evicts.  The harness runs the
cell through; the record, the traced slice's frames and the readers; the
check passes on the sound run and fails on the reference in TF32, on
prototypes chosen by the lowest usage and on prototypes whose values are
not potentiated."""
import json
import os
import types

import pytest
import torch

from bundlesdf_tpu_torch.models import xmem
from portbench import costs, xmem_costs
from portbench import run as R
from portbench.drivers import xmem_segment
from portbench.tests import xmem_faults
from portbench.tests.tiny import tiny_root

torch.set_num_threads(2)
CELL = "online_xmem.segment600"
SMALL = dict(mem_every=1, min_mid_term_frames=2, max_mid_term_frames=3,
             max_long_term_elements=48, num_prototypes=8, size=64)
TINY = dict(height=64, width=96, focal=80.0, frames=12, warm_frames=4, trace_frames=3,
            check_frames=6)
SEED = 2 ** 31 + 91


def tiny_plan(tmp_path) -> dict:
    root = tiny_root(tmp_path)
    path = os.path.join(root, "portbench", "configs", "online_xmem.json")
    cfg = json.load(open(path))
    cfg["xmem"].update(SMALL)
    json.dump(cfg, open(path, "w"))
    path = os.path.join(root, "portbench", "traffic", "seg600.json")
    traffic = json.load(open(path))
    traffic.update(TINY)
    json.dump(traffic, open(path, "w"))
    return R.plan(CELL, root)


def context(plan, tmp_path):
    return types.SimpleNamespace(config=plan["config"], traffic=plan["traffic"],
                                 limits=plan["workload"]["limits"], seed=SEED,
                                 device=torch.device("cpu"), tmp=str(tmp_path / "run"))


def failed(checks) -> list:
    return [c["name"] for c in checks if not c["value"] <= c["limit"]]


def test_harness_runs_the_cell(tmp_path):
    out = R.run_cell(tiny_plan(tmp_path), SEED, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"logit_gap", "readout_gap", "value_gap", "hidden_gap",
                                  "memory_gap", "memory_mismatch", "failed"}
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert out["attempted"] == 12 and out["failed"] == 0


def test_record_readers_and_controls(tmp_path, monkeypatch):
    plan = tiny_plan(tmp_path)
    cell = xmem_segment.Cell(context(plan, tmp_path))
    rec = cell.window(0.1)
    assert set(rec) == {"frames", "sessions", "window_s", "attempted", "failed", "spans"}
    assert rec["sessions"] == 1 and rec["frames"] == rec["attempted"] == 12
    # the window leaves a fresh session at the traced slice's start, and the
    # slice runs that session's last frames
    core = cell.seg.core
    assert core.ti == 12 - 3 - 1
    assert cell.traced_slice() == 3 and core.ti == 11 and core.memory.n_lt == 48
    spans = rec["spans"]
    assert spans["xmem/step"]["count"] == spans["xmem/frames"]["count"] == 12
    assert spans["xmem/read_memory"]["count"] == 11
    assert spans["xmem/mem_frames"]["count"] == 12
    assert spans["xmem/consolidations"]["count"] == 10
    assert spans["xmem/evicted"]["count"] == 32
    for child in ("encode_key", "read_memory", "decode", "encode_value", "readback"):
        assert spans[f"xmem/{child}"]["parents"] == {"xmem/step": spans[f"xmem/{child}"]
                                                     ["count"]}
    assert spans["xmem/consolidate"]["parents"] == {"xmem/step": 10}
    # 24 elements a memory frame: the working memory 24, 48, then 48 after
    # each consolidation; the long-term memory 0, 0, 8, ..., 48
    lt = [0, 0, 8, 16, 24, 32, 40, 48, 48, 48, 48]
    wm = [24] + [48] * 10
    assert spans["xmem/memory_elements"]["count"] == sum(lt) + sum(wm)
    assert spans["xmem/long_term_elements"]["count"] == sum(lt)
    trace = {"busy_s": 0.9, "window_s": 1.0}
    got = R.read_metrics(plan, {"cfg": plan["config"], "traffic": plan["traffic"],
                                "record": rec, "trace": trace}, "per_layer")
    # no CUDA events on the CPU: the read's device time is not measured
    assert set(got) == {"device_idle_share.frame", "xmem_memory_elements", "xmem_mfu"}
    assert got["xmem_memory_elements"]["value"] == pytest.approx((sum(lt) + sum(wm)) / 11)
    w = plan["config"]["xmem"]
    flops = (12 * xmem_costs.key_flops(w, 64, 96) + 11 * xmem_costs.decode_flops(w, 64, 96, False)
             + 12 * xmem_costs.value_flops(w, 64, 96)
             + xmem_costs.read_flops(w, sum(lt) + sum(wm), 64, 96))
    assert got["xmem_mfu"]["value"] == pytest.approx(
        100 * flops / spans["xmem/step"]["total_s"] / costs.PEAK_F32_FLOPS)
    checks = cell.verify()
    assert not failed(checks), checks
    limits = plan["workload"]["limits"]
    tf32 = cell.numbers("tf32")
    assert {k for k, v in tf32.items() if k in limits and v > limits[k]}, tf32
    # prototypes chosen by the lowest usage: the bookkeeping check fails
    top = xmem.stable_top
    monkeypatch.setattr(xmem, "stable_top", lambda x, n, largest: top(x, n, not largest))
    assert cell.numbers()["memory_mismatch"] > 0


def test_unpotentiated_prototypes_fail_the_store_check(tmp_path, monkeypatch):
    """Prototypes that keep their candidates' values: the next step's
    reference reads the same store and agrees, so of the checks only
    ``memory_gap`` fails.  The seeded keys lie so far apart that each
    prototype's affinity is its own alone and the fault moves nothing
    (``xmem_faults``), so these weights' keys are softened."""
    plan = tiny_plan(tmp_path)
    make = xmem_segment.ref_xmem.make_weights
    monkeypatch.setattr(xmem_segment.ref_xmem, "make_weights",
                        lambda seed, w: xmem_faults.soft_keys(make(seed, w)))
    cell = xmem_segment.Cell(context(plan, tmp_path))
    limits = plan["workload"]["limits"]
    held = {k: v for k, v in cell.numbers().items() if k in limits and v > limits[k]}
    assert not held, held
    with xmem_faults.unpotentiated() as shares:
        nums = cell.numbers()
    assert shares and min(shares) > 0.1, shares
    assert [k for k, v in nums.items() if k in limits and v > limits[k]] == ["memory_gap"], nums


def test_read_ms_reader():
    from portbench.metrics import xmem_read_ms_per_frame as m

    rec = {"frames": 600, "spans": {"xmem/read_memory_device_us": {"count": 1_200_000}}}
    assert m.read({"record": rec}) == pytest.approx(2.0)
    assert m.read({"record": {"frames": 600, "spans": {}}}) is None


def test_frames_are_the_cube_renderers():
    """The traffic's frames, ray-traced in torch, are ``video.
    render_cube_rgbd``'s colour truncated to uint8, bit for bit, and the
    first frame's mask its mask; every frame differs from the others."""
    import numpy as np

    from portbench import seg_frames, video

    t = dict(height=48, width=64, focal=60.0, deg_step=1.2, wobble=0.25, half=0.15, frames=4)
    got = seg_frames.make_frames(t, SEED, "cpu")
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    for k, T in enumerate(video.synth_poses(4, 1.2, 0.25)):
        rgb, _, mask = video.render_cube_rgbd(T, K, 48, 64, half=0.15,
                                              salt=video.dot_salt(SEED))
        np.testing.assert_array_equal(got["colors"][k], rgb.astype(np.uint8))
        if k == 0:
            np.testing.assert_array_equal(got["mask0"], mask)
    assert len({c.tobytes() for c in got["colors"]}) == 4
