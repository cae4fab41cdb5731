"""The harness on the CPU: what BENCHMARK.json names is found by name, a
cell or a metric is added with files alone, the window arithmetic, the
result line's shape and the import guard."""
import json
import os
import re
import statistics
import subprocess
import sys
import types

import pytest
import torch

from portbench import guard, run as R
from portbench.tests.tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and 1 <= len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200
        assert set(c["reduced"]) == set(json.load(open(os.path.join(REPO, c["file"])))["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                      "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    p = R.plan(cell)
    assert p["config"]["name"] == p["entry"]["config"]
    assert os.path.exists(os.path.join(REPO, "portbench", "drivers",
                                       f"{p['workload']['driver']}.py"))
    names = [m["name"] for m in p["end_to_end"] + p["per_layer"]]
    assert "setup_s" in names and len(p["end_to_end"]) >= 2 and p["per_layer"]
    for n in names:
        assert os.path.exists(os.path.join(p["metrics_dir"], f"{n}.py"))
    for m in p["per_layer"]:
        assert m["moves"] in {e["name"] for e in p["end_to_end"]}


def test_a_cell_added_as_data_files_runs_its_driver(tmp_path):
    """A new traffic, cell and per-layer metric: files and BENCHMARK.json
    entries only; the harness runs the existing driver on them."""
    root = tiny_root(tmp_path)
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b["workloads"].append({"name": "online.nof_train_small_pool", "config": "online",
                           "traffic": "pool3", "chips": 1, "why": "a smaller pool"})
    for m in b["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("online.nof_train_small_pool")
    b["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "NOF runner and train step",
                           "moves": "train_step_ms"})
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    t = json.load(open(os.path.join(root, "portbench", "traffic", "pool16.json")))
    json.dump(dict(t, frames=3), open(os.path.join(root, "portbench", "traffic", "pool3.json"),
                                      "w"))
    w = json.load(open(os.path.join(root, "portbench", "workloads", "online.nof_train.json")))
    json.dump(dict(w, traffic="pool3"),
              open(os.path.join(root, "portbench", "workloads",
                                "online.nof_train_small_pool.json"), "w"))
    with open(os.path.join(root, "portbench", "metrics", "steps_in_window.py"), "w") as f:
        f.write("def read(run):\n    return run['record'].get('steps')\n")
    p = R.plan("online.nof_train_small_pool", root)
    assert [m["name"] for m in p["per_layer"]] == ["steps_in_window"]
    out = R.run_cell(p, 2 ** 31 + 11, 1.0, False, "cpu")
    assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    assert out["correct"] and out["attempted"] > 0
    assert R.read_metrics(p, {"record": {"steps": 7}}, "per_layer") == {
        "steps_in_window": {"value": 7, "unit": "steps"}}


def _read(name, run):
    p = {"metrics_dir": os.path.join(REPO, "portbench", "metrics"),
         "x": [{"name": name, "unit": "ms"}]}
    got = R.read_metrics(p, run, "x")
    return got[name]["value"] if got else None


def test_window_arithmetic_counts_the_whole_window():
    lat = [0.3] * 100
    run = {"record": {"frames": 100, "latencies_s": lat, "window_s": 30.0}, "trace": None}
    assert _read("frame_ms", run) == pytest.approx(300.0)
    assert _read("frame_ms_p90", run) == pytest.approx(300.0)
    # a stall in the window: one frame takes 12 s more; the rate sees it
    # whole, the p90 only once 11 frames stall
    stalled = {"record": {"frames": 100, "latencies_s": lat[:-1] + [12.3], "window_s": 42.0},
               "trace": None}
    assert _read("frame_ms", stalled) == pytest.approx(420.0)
    many = [0.3] * 89 + [2.3] * 11
    run = {"record": {"frames": 100, "latencies_s": many, "window_s": sum(many)}, "trace": None}
    assert _read("frame_ms_p90", run) == pytest.approx(
        statistics.quantiles([x * 1e3 for x in many], n=10, method="inclusive")[8])
    assert _read("frame_ms_p90", run) > 1000.0
    steps = {"record": {"steps": 1000, "window_s": 10.5}, "trace": None}
    assert _read("train_step_ms", steps) == pytest.approx(10.5)
    assert _read("frame_ms", steps) is None and _read("train_mfu", steps) is None


def test_device_readers_read_the_trace_and_nothing_else():
    trace = {"busy_s": 0.9, "window_s": 1.0, "units": 16,
             "kernels": {"reduce_cell_cache_grad_kernel": {"seconds": 16 * 4.4e-5, "calls": 32},
                         "other": {"seconds": 0.5, "calls": 100}}}
    cfg = json.load(open(os.path.join(REPO, "portbench", "configs", "online.json")))
    run = {"record": {"steps": 1000, "window_s": 10.0}, "trace": trace, "cfg": cfg}
    assert _read("device_idle_share.train", run) == pytest.approx(0.1)
    assert _read("device_idle_share.frame", run) is None
    share = _read("reduce_roofline", run)
    assert 60.0 < share < 70.0      # the 0.0283 ms bound against 0.044 ms
    assert 0 < _read("train_mfu", run) < 100
    no_reduce = dict(run, trace=dict(trace, kernels={"other": trace["kernels"]["other"]}))
    assert _read("reduce_roofline", no_reduce) is None
    assert _read("reduce_roofline", dict(run, trace=None)) is None


def test_result_line_has_the_contract_keys(tmp_path):
    root = tiny_root(tmp_path)
    out = R.run_cell(R.plan("online.nof_train", root), 5, 1.0, False, "cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_same_seed_same_inputs(tmp_path):
    from portbench import draws, video

    t = json.load(open(os.path.join(REPO, "portbench", "traffic", "track60.json")))
    t = dict(t, frames=2, height=48, width=64, focal=60.0)
    a, b, c = video.make_video(t, 2 ** 31 + 3), video.make_video(t, 2 ** 31 + 3), \
        video.make_video(t, 4)
    assert all((x == y).all() for x, y in zip(a["colors"], b["colors"]))
    assert any((x != y).any() for x, y in zip(a["colors"], c["colors"]))
    assert all((x == y).all() for x, y in zip(a["depths"], c["depths"]))
    cfg = {"N_rand": 8, "N_samples": 4, "N_samples_around_depth": 2}
    d1, d2 = draws.NofDraws(cfg, 2 ** 33, "cpu"), draws.NofDraws(cfg, 2 ** 33, "cpu")
    i1, u1 = d1(0, 100)
    i2, u2 = d2(0, 100)
    assert torch.equal(i1, i2) and torch.equal(u1[0], u2[0]) and u1[3] is None
    r = draws.ransac_draws(2 ** 31 + 9)
    assert torch.equal(r(3, (2, 5)), r(3, (2, 5))) and not torch.equal(r(3, (2, 5)),
                                                                       r(4, (2, 5)))


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules({"bundlesdf_tpu_torch": 1, "bundlesdf_tpu_torch.ops": 1,
                                    "jaxtyping": 1, "numpy": 1}) == []
    stand_in = {"bundlesdf_tpu": types.ModuleType("bundlesdf_tpu"),
                "bundlesdf_tpu.ops.x": 1, "jax.numpy": 1, "jaxlib": 1}
    assert guard.forbidden_modules(stand_in) == ["bundlesdf_tpu", "bundlesdf_tpu.ops.x",
                                                 "jax.numpy", "jaxlib"]
    assert guard.forbidden_modules({"bundlesdf_tpu_torch": 1}) == []


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("the card is here")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "online.nof_train",
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_harness_imports_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, {!r}); import portbench.run, portbench.drivers.video, "
            "portbench.drivers.nof_train, portbench.reference.nof_step; "
            "import bundlesdf_tpu_torch.entry; from portbench import guard; "
            "assert not guard.forbidden_modules(), guard.forbidden_modules()").format(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
