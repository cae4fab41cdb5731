"""The port's span profiler as a tree (``utils/profiler.py``): nesting,
self time and parents, one stack a thread, the ``torch.profiler`` ranges
the spans open while a session records and only then, the printed tree;
the spans the tracker and the NOF round open under their parents; and the
benchmark's readers of those spans (``portbench/metrics``)."""
import importlib.util
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from synthetic_cube import make_cube_sequence
from test_pipeline import small_track_cfg
from test_torch_scheduler import _cfgs, _feed
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_track_config
from bundlesdf_tpu_torch.tracking import pool as pool_mod
from bundlesdf_tpu_torch.utils import profiler

torch.set_num_threads(2)

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "portbench", "metrics")


@pytest.fixture(autouse=True)
def fresh_profiler():
    profiler.enable(True)
    profiler.reset()
    yield
    profiler.enable(True)
    profiler.reset()


def test_spans_nest_with_self_time_and_parents():
    with profiler.span("a"):
        time.sleep(0.02)
        with profiler.span("b"):
            time.sleep(0.03)
            with profiler.span("c"):
                time.sleep(0.01)
        with profiler.span("b"):
            pass
        profiler.count("a/hit", 2)
    st = profiler.stats()
    assert st["a"]["parents"] == {None: 1}
    assert st["b"]["parents"] == {"a": 2} and st["b"]["count"] == 2
    assert st["c"]["parents"] == {"b": 1}
    # self time: the total less what the direct children cover
    assert st["a"]["self_s"] == pytest.approx(st["a"]["total_s"] - st["b"]["total_s"])
    assert st["b"]["self_s"] == pytest.approx(st["b"]["total_s"] - st["c"]["total_s"])
    assert st["c"]["self_s"] == pytest.approx(st["c"]["total_s"])
    assert 0.015 < st["a"]["self_s"] < st["a"]["total_s"]
    assert st["a"]["total_s"] >= 0.06 and st["b"]["self_s"] >= 0.03
    for s in st.values():
        assert set(s) == {"count", "total_s", "mean_s", "max_s", "self_s", "parents"}
    # a counter keeps its count column and no time, as before
    assert st["a/hit"]["count"] == 2 and st["a/hit"]["total_s"] == 0.0
    # a name opened under several parents counts each
    with profiler.span("b"):
        pass
    assert profiler.stats()["b"]["parents"] == {"a": 2, None: 1}


def test_a_span_on_a_second_thread_has_its_own_stack():
    """A span opened on another thread while ``outer`` is open here is a
    root there; it takes nothing from ``outer``'s self time, and its own
    child nests under it."""
    started, release = threading.Event(), threading.Event()

    def work():
        with profiler.span("thread/root"):
            with profiler.span("thread/child"):
                started.set()
                release.wait(5)
                time.sleep(0.02)

    with profiler.span("outer"):
        t = threading.Thread(target=work)
        t.start()
        assert started.wait(5)
        release.set()
        t.join(5)
        assert not t.is_alive()
    st = profiler.stats()
    assert st["thread/root"]["parents"] == {None: 1}
    assert st["thread/child"]["parents"] == {"thread/root": 1}
    assert st["outer"]["parents"] == {None: 1}
    assert st["outer"]["self_s"] == pytest.approx(st["outer"]["total_s"])


def test_spans_on_many_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span and
    count is recorded, each under its own thread's parent."""
    import sys

    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiler.span("stress/outer"):
                    with profiler.span("stress/inner"):
                        profiler.count("stress/count")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    st = profiler.stats()
    assert st["stress/outer"]["count"] == st["stress/inner"]["count"] == n_threads * n
    assert st["stress/count"]["count"] == n_threads * n
    assert st["stress/inner"]["parents"] == {"stress/outer": n_threads * n}
    assert st["stress/outer"]["parents"] == {None: n_threads * n}


def test_profiler_ranges_open_only_while_a_session_records(monkeypatch):
    """Inside a ``torch.profiler`` session every span is a range of its name
    in the session's events, nested as the spans are; with no session a
    span opens no ``record_function`` at all."""
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiler.span("pipeline/run"):
        with profiler.span("track/x"):
            torch.ones(3).add_(1)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("pipeline/run"):
            with profiler.span("track/x"):
                torch.ones(3).add_(1)
    assert opened == ["pipeline/run", "track/x"]
    ev = {e.name: e for e in prof.events() if e.name in ("pipeline/run", "track/x")}
    assert set(ev) == {"pipeline/run", "track/x"}
    assert ev["track/x"].cpu_parent is not None
    assert ev["track/x"].cpu_parent.name == "pipeline/run"
    assert ev["pipeline/run"].time_range.start <= ev["track/x"].time_range.start
    assert ev["track/x"].time_range.end <= ev["pipeline/run"].time_range.end
    opened.clear()
    with profiler.span("after"):
        pass
    assert opened == []
    # the spans recorded both times, session or not
    assert profiler.stats()["track/x"]["count"] == 2


def test_enable_false_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: opened.append(a))
    profiler.enable(False)
    ran = []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("off/outer"):
            with profiler.span("off/inner"):
                ran.append(1)
        profiler.count("off/count")
    assert ran == [1] and opened == [] and profiler.stats() == {}
    profiler.enable(True)
    with profiler.span("on/outer"):
        pass
    assert profiler.stats()["on/outer"]["parents"] == {None: 1}


def test_a_decorated_function_spans_each_call():
    @profiler.span("deco/leaf")
    def leaf():
        return 7

    @profiler.span("deco/root")
    def root():
        return leaf() + leaf()

    assert root() == 14 and root() == 14
    st = profiler.stats()
    assert st["deco/root"]["count"] == 2 and st["deco/leaf"]["parents"] == {"deco/root": 4}


def test_report_prints_the_tree():
    with profiler.span("pipeline/run"):
        with profiler.span("track/make_frame"):
            with profiler.span("track/depth/bilateral"):
                time.sleep(0.002)
        with profiler.span("track/process_new_frame"):
            pass
    profiler.count("launch/x", 3)
    lines = profiler.report().splitlines()
    assert lines[0].split() == ["span", "count", "total", "self", "mean", "max"]
    rows = {ln.strip().split()[0]: ln for ln in lines[1:]}
    indent = {k: len(v) - len(v.lstrip()) for k, v in rows.items()}
    assert indent["pipeline/run"] == 0 and indent["launch/x"] == 0
    assert indent["track/make_frame"] == indent["track/process_new_frame"] == 2
    assert indent["track/depth/bilateral"] == 4
    names = [ln.strip().split()[0] for ln in lines[1:]]
    assert names.index("pipeline/run") < names.index("track/make_frame") < names.index(
        "track/depth/bilateral") < names.index("track/process_new_frame")
    assert rows["launch/x"].split()[1] == "3"
    # the filter drops rows, not their children's place in the tree
    short = profiler.report(min_total=0.001).splitlines()
    assert not any("launch/x" in ln for ln in short)
    assert any(ln.startswith("    track/depth/bilateral") for ln in short)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _s(total, count=1, self_s=None):
    return {"count": count, "total_s": total, "mean_s": total / count, "max_s": total,
            "self_s": total if self_s is None else self_s, "parents": {None: count}}


SPANS = {"track/make_frame": _s(1.2, 4), "track/select_keyframes": _s(0.8, 4),
         "track/covisibility": _s(0.3, 60), "pipeline/run": _s(6.0, 4, self_s=0.04),
         "nof/fuse_cluster": _s(2.0, 4), "nof/train_drain": _s(0.6, 4),
         "nof/capture": _s(0.4, 1), "nof/train_advance": _s(1.0, 8)}

READERS = [("make_frame_ms_per_frame", "track/make_frame", 300.0),
           ("keyframe_select_ms_per_frame", "track/select_keyframes", 200.0),
           ("covisibility_per_frame", "track/covisibility", 15.0),
           ("run_self_ms_per_frame", "pipeline/run", 10.0),
           ("fuse_cluster_ms_per_frame", "nof/fuse_cluster", 500.0),
           ("drain_wait_ms_per_frame", "nof/train_drain", 150.0),
           ("capture_ms_per_frame", "nof/capture", 100.0)]


@pytest.mark.parametrize("name,span,want", READERS)
def test_span_readers(name, span, want):
    read = _reader(name)
    run = {"record": {"frames": 4, "window_s": 10.0, "spans": dict(SPANS)}, "trace": None}
    assert read(run) == pytest.approx(want)
    gone = {k: v for k, v in SPANS.items() if k not in (span, "nof/train_advance")}
    assert read({"record": {"frames": 4, "spans": gone}, "trace": None}) is None
    assert read({"record": {"frames": 4}, "trace": None}) is None
    assert read({"record": {"steps": 100, "window_s": 1.0}, "trace": None}) is None
    assert read({"record": {"frames": 0, "spans": dict(SPANS)}, "trace": None}) is None


def test_capture_reader_reads_zero_where_the_nof_trained_without_capturing():
    read = _reader("capture_ms_per_frame")
    spans = {k: v for k, v in SPANS.items() if k != "nof/capture"}
    assert read({"record": {"frames": 4, "spans": spans}, "trace": None}) == 0.0
    # a parent's span table without self time: the root reader finds nothing
    old = {"pipeline/run": {k: v for k, v in SPANS["pipeline/run"].items() if k != "self_s"}}
    assert _reader("run_self_ms_per_frame")({"record": {"frames": 4, "spans": old}}) is None


@pytest.fixture(scope="module")
def cube():
    return make_cube_sequence(n_frames=6, deg_per_frame=6.0)


def test_tracker_spans_sit_under_their_parents(cube, monkeypatch):
    """One tracking-only run of the small cube: a root ``pipeline/run`` a
    frame, the depth pipeline's three stages under ``track/make_frame``,
    the denoise and the fused pack under ``track/process_new_frame``, one
    ``track/covisibility`` span for each covisibility computed and a hit
    counted for each one the cache served."""
    computed = []
    real = pool_mod.compute_covisibility

    def counting(*a):
        computed.append(1)
        return real(*a)

    monkeypatch.setattr(pool_mod, "compute_covisibility", counting)
    calls = []
    real_cov = pool_mod.Bundler.covisibility

    def cov(self, fa, fb):
        calls.append(1)
        return real_cov(self, fa, fb)

    monkeypatch.setattr(pool_mod.Bundler, "covisibility", cov)
    cfg = small_track_cfg()
    cfg["depth_processing"]["denoise_cloud"] = True
    tracker = entry.build_tracker(Cfg.wrap(default_track_config().merged(cfg)), device="cpu")
    n = len(cube["colors"])
    _feed(tracker, cube, n)
    st = profiler.stats()
    assert st["pipeline/run"]["parents"] == {None: n}
    for name in ("track/make_frame", "track/process_new_frame"):
        assert st[name]["parents"] == {"pipeline/run": n}, name
    for name in ("track/depth/erode", "track/depth/bilateral", "track/depth/cloud"):
        assert st[name]["parents"] == {"track/make_frame": n}, name
    assert st["track/denoise"]["parents"] == {"track/process_new_frame": n}
    assert st["track/fused_pack"]["parents"] == {"track/process_new_frame": n - 1}
    assert set(st["track/covisibility"]["parents"]) <= {"track/process_new_frame",
                                                        "track/select_keyframes"}
    hits = st.get("track/covisibility_hit", {"count": 0})["count"]
    assert st["track/covisibility"]["count"] == len(computed) > 0
    assert len(computed) + hits == len(calls)
    mf = st["track/make_frame"]
    stages = sum(st[k]["total_s"] for k in ("track/depth/erode", "track/depth/bilateral",
                                            "track/depth/cloud"))
    assert mf["self_s"] == pytest.approx(mf["total_s"] - stages, abs=1e-9)
    run = st["pipeline/run"]
    assert 0.0 <= run["self_s"] < 0.5 * run["total_s"]
    assert "pipeline/run" in profiler.report()


def test_nof_round_spans_sit_under_their_parents(cube):
    """The joint loop on the small cube under strict sync: the round's
    cloud work divided into fusion, downsample and clustering under
    ``nof/fuse_cluster``, the preprocessing under ``nof/round_start``, the
    round start and the sync wait under a frame's ``pipeline/run``."""
    pipe = entry.build_pipeline(*_cfgs(n_step=10, n_step_extend=5, loop_chunk=5,
                                       calibrate_step=False),
                                start_nerf_keyframes=3, device="cpu")
    _feed(pipe, cube, 5)
    st = profiler.stats()
    k = st["nof/fuse_cluster"]["count"]
    assert k >= 1 and st["nof/fuse_cluster"]["parents"] == {"nof/round_start": k}
    for name in ("nof/fuse_cloud", "nof/voxel_downsample", "nof/cluster"):
        assert st[name]["parents"] == {"nof/fuse_cluster": k}, name
    rounds = st["nof/round_start"]["count"]
    assert st["nof/preprocess"]["parents"] == {"nof/round_start": rounds}
    assert st["nof/round_start"]["parents"] == {"pipeline/run": rounds}
    assert set(st["nof/sync_wait"]["parents"]) == {"pipeline/run"}
    assert set(st["nof/train_drain"]["parents"]) <= {"nof/sync_wait", "pipeline/run"}
    fc = st["nof/fuse_cluster"]
    parts = sum(st[n]["total_s"] for n in ("nof/fuse_cloud", "nof/voxel_downsample",
                                           "nof/cluster"))
    assert fc["self_s"] == pytest.approx(fc["total_s"] - parts, abs=1e-9)
    assert pipe.nof.total_step > 0


def test_frames_run_under_the_benchmarks_span_labels(cube):
    """The benchmark's traced slice rebinds every module's ``span`` to a
    labelled ``span(name)`` (``portbench/drivers/common.py``); the frame's
    root span, opened with its frame id, runs under it, and every span is
    a range of the session and keeps its parent."""
    from portbench.drivers.common import span_labels

    cfg = Cfg.wrap(default_track_config().merged(small_track_cfg()))
    tracker = entry.build_tracker(cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span_labels():
            _feed(tracker, cube, 2)
    names = {e.name for e in prof.events()}
    assert {"pipeline/run", "track/make_frame", "track/depth/bilateral",
            "track/process_new_frame"} <= names
    st = profiler.stats()
    assert st["pipeline/run"]["parents"] == {None: 2}
    assert st["track/depth/cloud"]["parents"] == {"track/make_frame": 2}
