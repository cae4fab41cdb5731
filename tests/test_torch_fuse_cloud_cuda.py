"""A keyframe's cloud fusion on the card (``ops/fuse_cloud_cuda.py``,
``csrc/fuse_cloud.cu``) on the CPU: the kernels' source built for the host
and driven by the wrapper's own ``compute`` against the numpy twin
(``io/scene_bounds.py``), bit for bit, on the joint60 traffic's cube frames
and on hard frames; a voxel key out of the packed range raising; the
routing by device of ``fuse_frame_clouds`` and ``compute_scene_bounds``;
the pipeline's device at both call sites; the C entry points' ctypes
signatures; and the ``fuse_device_per_frame`` reader.  ``chip_smoke.py``'s
``fuse_cloud`` phase holds the kernels themselves to the twin on the card,
on every joint60 keyframe.

This file imports nothing of the JAX package at its top: the pipeline test
imports its configs when it runs.
"""
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from port_fuse_cloud_kernel import (REPO, SOURCE, cube_frames, hard_frames, hard_k,
                                    host_launch, run_on_host)
from bundlesdf_tpu_torch.io import scene_bounds as sb
from bundlesdf_tpu_torch.ops import _cuda_lib
from bundlesdf_tpu_torch.ops import fuse_cloud_cuda as fc
from bundlesdf_tpu_torch.utils import profiler

K31 = sb.FUSE_NEIGHBORS + 1


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernels' source for the host")
    return host_launch(str(tmp_path_factory.mktemp("fuse_cloud_kernel")))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The device steps replaced by the host: the launches run the kernels'
    source, the upload is ``pack`` into a CPU tensor; returns the stand-in,
    whose ``batches`` lists each batch's frame count."""
    monkeypatch.setattr(_cuda_lib, "launch", host_lib)
    run = run_on_host(host_lib)
    monkeypatch.setattr(fc, "_run_kernel", run)
    profiler.reset()
    yield run
    profiler.reset()


@pytest.fixture(scope="module")
def cube():
    small = cube_frames(2, 240, 320, seed=2147483001)
    full = cube_frames(1, 480, 640, seed=2147483001, first=30)
    return small, full


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


def _assert_same(got, want):
    """Bitwise equal f64 arrays, or both None."""
    if want is None:
        assert got is None
        return
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _twin_voxels(depth, mask, K):
    """The twin's voxel means, its cKDTree distances and its keep mask."""
    pts, _ = sb._frame_voxels(depth, None, mask, K)
    if pts is None:
        return None, None, None
    d = None
    keep = np.ones(len(pts), bool)
    if len(pts) > sb.FUSE_NEIGHBORS:
        d, _ = cKDTree(pts).query(pts, k=K31, workers=-1)
        keep = sb.remove_statistical_outliers(pts, sb.FUSE_NEIGHBORS, sb.FUSE_STD_RATIO)
    return pts, d, keep


def _check_frames(depths, masks, K, glcams):
    """The kernels' voxels, distances and keep masks against the twin's, and
    ``fuse_frame_clouds`` on a CUDA device against the CPU's; returns the
    kernels' voxel counts."""
    got = fc.frame_voxels(depths, masks, K, "cuda", sb.FUSE_VOXEL, K31)
    sizes = []
    for i, (v_pts, v_d) in enumerate(got):
        pts, d, keep = _twin_voxels(depths[i], masks[i], K)
        if pts is None:
            assert len(v_pts) == 0
            sizes.append(0)
            continue
        _assert_same(v_pts, pts)
        if d is not None:
            _assert_same(v_d, d)
            np.testing.assert_array_equal(sb.outlier_keep(v_d, sb.FUSE_STD_RATIO), keep)
        else:
            assert np.isinf(v_d[:, len(pts):]).all()
        sizes.append(len(pts))
    on_card = sb.fuse_frame_clouds(depths, masks, K, glcams, device="cuda")
    on_cpu = sb.fuse_frame_clouds(depths, masks, K, glcams, device="cpu")
    for a, b in zip(on_card, on_cpu):
        _assert_same(a, b)
    return sizes


@pytest.mark.parametrize("size", [0, 1], ids=["240x320", "480x640"])
def test_kernels_on_the_host_are_the_twin_on_cube_frames(on_host, cube, size):
    """The joint60 traffic's cube frames (depth in mm steps, so many points
    sit on voxel faces), 2 at 240 x 320 or 1 at 480 x 640: the voxel
    points are the twin's bits in the twin's order, the neighbour distances
    cKDTree's bits, the keep masks and the world points equal; one batch
    each call."""
    data = cube[size]
    n = len(data["depths"])
    sizes = _check_frames(data["depths"], data["masks"], data["K"], data["glcams"])
    assert min(sizes) > 300
    assert on_host.batches == [n, n]
    st = profiler.stats()
    assert st["nof/fuse_cloud_frames"]["count"] == 2 * n
    assert st["launch/fuse_cloud"]["count"] == 5 * len(on_host.batches)


CASES = ["empty", "one_voxel", "faces", "lattice", "few", "noisy"]


@pytest.mark.parametrize("case", CASES)
def test_kernels_on_the_host_are_the_twin_on_hard_frames(on_host, case):
    """An empty mask gives None; one voxel one point; voxel faces and
    negative coordinates, a lattice's tied distances, fewer points than the
    neighbours (all kept) and a noisy surface: the twin's bits."""
    H, W = 60, 80
    K = hard_k(H, W)
    depth, mask = hard_frames(H, W, seed=7)[case]
    glc = [np.eye(4)]
    sizes = _check_frames([depth], [mask], K, glc)
    pts = sb.fuse_frame_clouds([depth], [mask], K, glc, device="cuda")[0]
    if case == "empty":
        assert sizes == [0] and pts is None
    elif case == "one_voxel":
        assert sizes == [1] and len(pts) == 1
    elif case == "few":
        assert 1 < sizes[0] <= sb.FUSE_NEIGHBORS and len(pts) == sizes[0]
    else:
        assert sizes[0] > K31
    if case == "faces":
        q = np.floor(sb._frame_voxels(depth, None, mask, K)[0] / sb.FUSE_VOXEL)
        assert (q < 0).any() and (q >= 0).any()
        xyz = np.asarray(depth, np.float32)[mask > 0] / np.float32(sb.FUSE_VOXEL)
        assert (xyz == np.floor(xyz)).any()            # depths on voxel faces
    if case == "lattice":
        d = fc.frame_voxels([depth], [mask], K, "cuda", sb.FUSE_VOXEL, K31)[0][1]
        assert (np.diff(d[:, 1:], axis=1) == 0).any(axis=1).mean() > 0.5


@pytest.mark.parametrize("far", [2e4, np.inf], ids=["20km", "inf"])
def test_a_key_out_of_range_raises(on_host, far):
    """A patch at 20 km, or at an infinite depth, puts voxel keys past the
    packed range: the call raises and names the frame, and counts no frame
    as fused on the card."""
    H, W = 60, 80
    K = hard_k(H, W)
    hard = hard_frames(H, W, seed=8)
    depths, masks = (list(x) for x in zip(hard["faces"], hard["faces"], hard["noisy"]))
    depths[1] = depths[1].copy()
    depths[1][:H // 8, :W // 8] = far
    with pytest.raises(ValueError, match="frame 1 of the batch"):
        fc.frame_voxels(depths, masks, K, "cuda", sb.FUSE_VOXEL, K31)
    with pytest.raises(ValueError, match="outside the packed range"):
        sb.fuse_frame_clouds(depths, masks, K, [np.eye(4)] * 3, device="cuda")
    assert "nof/fuse_cloud_frames" not in profiler.stats()


def test_a_long_batch_goes_in_chunks(on_host):
    """More frames than ``CHUNK`` go to the card in batches of ``CHUNK``;
    frames of different sizes share a batch (their outputs at their
    offsets)."""
    H, W = 48, 64
    K = hard_k(H, W)
    names = ["noisy", "empty", "faces", "few", "lattice", "one_voxel"]
    frames = [hard_frames(H, W, seed=s)[names[s % len(names)]] for s in range(fc.CHUNK + 3)]
    depths, masks = (list(x) for x in zip(*frames))
    _check_frames(depths, masks, K, [np.eye(4)] * len(frames))
    assert on_host.batches == [fc.CHUNK, 3, fc.CHUNK, 3]


def test_compute_scene_bounds_on_a_cuda_device_is_the_cpus(on_host, cube):
    """``compute_scene_bounds`` with a CUDA device fuses on the card and
    gives the CPU's bounds and clouds bit for bit."""
    data = cube[0]
    args = (None, np.stack(data["depths"]), np.stack(data["masks"]),
            data["K"], np.stack(data["glcams"]))
    got = sb.compute_scene_bounds(*args, device="cuda")
    want = sb.compute_scene_bounds(*args, device="cpu")
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        _assert_same(a, b)
    assert on_host.batches == [2]


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_cpu_route_is_the_twin(device, monkeypatch):
    """With no device or a CPU one, the twin runs and nothing launches."""
    monkeypatch.setattr(fc, "_run_kernel", lambda *a: pytest.fail("the kernel ran"))
    H, W = 48, 64
    K = hard_k(H, W)
    depth, mask = hard_frames(H, W, seed=3)["noisy"]
    before = fc.launches
    pts = sb.fuse_frame_clouds([depth], [mask], K, [np.eye(4)], device=device)[0]
    want_pts, _, keep = _twin_voxels(depth, mask, K)
    _assert_same(pts, want_pts[keep] @ sb.GLCAM_IN_CVCAM[:3, :3].T + sb.GLCAM_IN_CVCAM[:3, 3])
    _assert_same(pts, sb.fuse_frame_cloud(depth, None, mask, K, np.eye(4))[0])
    assert fc.launches == before


def test_a_cuda_device_takes_the_kernel(monkeypatch):
    """On a CUDA device every frame goes to the kernel in one call under
    ``nof/fuse_cloud/device`` (no card needed: the launch is replaced)."""
    calls = []

    def fake(dev, depths, masks, K, vox, k):
        calls.append((dev.type, len(depths), vox, k))
        return [(np.zeros((0, 3)), np.zeros((0, k)))] * len(depths)

    monkeypatch.setattr(fc, "_run_kernel", fake)
    profiler.reset()
    H, W = 24, 32
    K = hard_k(H, W)
    depth, mask = hard_frames(H, W, seed=4)["noisy"]
    out = sb.fuse_frame_clouds([depth] * 3, [mask] * 3, K, [np.eye(4)] * 3, device="cuda:0")
    assert out == [None] * 3
    assert calls == [("cuda", 3, sb.FUSE_VOXEL, K31)]
    st = profiler.stats()
    assert st["nof/fuse_cloud/device"]["count"] == 1
    assert st["nof/fuse_cloud_frames"]["count"] == 3
    profiler.reset()


def test_the_pipeline_passes_its_device_at_both_call_sites(monkeypatch):
    """The joint loop on the small cube: the first round's
    ``compute_scene_bounds`` and each later round's ``fuse_frame_clouds``
    (all of the round's new keyframes in one call, under
    ``nof/fuse_cloud``) get the pipeline's device."""
    from synthetic_cube import make_cube_sequence
    from test_torch_scheduler import _cfgs, _feed
    from bundlesdf_tpu_torch import entry

    seen = []
    bounds, clouds = sb.compute_scene_bounds, sb.fuse_frame_clouds

    def spy_bounds(*a, **kw):
        seen.append(("bounds", len(a[1]), kw.get("device")))
        return bounds(*a, **kw)

    def spy_clouds(depths, masks, K, glcams, device=None):
        stack = getattr(profiler._LOCAL, "stack", [])
        if stack and stack[-1].name == "nof/fuse_cloud":
            seen.append(("clouds", len(depths), device))
        return clouds(depths, masks, K, glcams, device)

    monkeypatch.setattr(sb, "compute_scene_bounds", spy_bounds)
    monkeypatch.setattr(sb, "fuse_frame_clouds", spy_clouds)
    pipe = entry.build_pipeline(*_cfgs(n_step=10, n_step_extend=5, loop_chunk=5,
                                       calibrate_step=False),
                                start_nerf_keyframes=3, device="cpu")
    _feed(pipe, make_cube_sequence(n_frames=5, deg_per_frame=6.0), 5)
    dev = pipe.device
    assert seen[0][0] == "bounds" and seen[0][2] == dev
    rounds = [s for s in seen if s[0] == "clouds"]
    assert rounds and all(s[2] == dev and s[1] >= 1 for s in rounds)


def test_ctypes_signatures_match_the_c_entry_points():
    """``_SIGNATURES`` has one ctypes type of the right width per parameter
    of each C entry point, the stream last; the source is built and its
    wrapper's launches counted; a block's tile fits its static shared
    memory; the neighbour list holds the outlier test's neighbours."""
    src = open(SOURCE).read()
    kinds = {"int": _cuda_lib._I, "float": _cuda_lib._F, "double": _cuda_lib._D}
    names = re.findall(r'extern "C" int (fuse_cloud_\w+)\(', src)
    assert sorted(names) == sorted(n for n in _cuda_lib._SIGNATURES if n.startswith("fuse_"))
    assert len(names) == 5
    for name in names:
        params = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S).group(1)
        want = [_cuda_lib._P if "*" in p else kinds[p.split()[0]] for p in params.split(",")]
        assert list(_cuda_lib._SIGNATURES[name]) == want, name
    assert "fuse_cloud.cu" in _cuda_lib.SOURCES and "fuse_cloud_cuda" in _cuda_lib.COUNTED
    tile = int(re.search(r"constexpr int kKnnTile = (\d+);", src).group(1))
    assert 3 * tile * 8 <= 48 * 1024
    assert int(re.search(r"constexpr int kMaxK = (\d+);", src).group(1)) >= K31


def _reader():
    path = os.path.join(REPO, "portbench", "metrics", "fuse_device_per_frame.py")
    spec = importlib.util.spec_from_file_location("fuse_device_per_frame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("count,frames,want", [(34, 34, 1.0), (17, 34, 0.5), (36, 34, 36 / 34)])
def test_fuse_device_reader(count, frames, want):
    """The counter ``nof/fuse_cloud_frames`` over the window's frames; None
    where the program has no such counter, or the run no frames."""
    read = _reader()
    counter = {"count": count, "total_s": 0.0, "mean_s": 0.0, "max_s": 0.0, "self_s": 0.0,
               "parents": {}}
    spans = {"nof/fuse_cloud": {"count": frames, "total_s": 1.0, "mean_s": 0.03,
                                "max_s": 0.05, "self_s": 0.1,
                                "parents": {"nof/fuse_cluster": frames}},
             "nof/fuse_cloud_frames": counter}
    assert read({"record": {"frames": frames, "spans": spans}, "trace": None}) == want
    parent = {k: v for k, v in spans.items() if k != "nof/fuse_cloud_frames"}
    assert read({"record": {"frames": frames, "spans": parent}, "trace": None}) is None
    assert read({"record": {"frames": 0, "spans": spans}, "trace": None}) is None
    assert read({"record": {"steps": 100, "window_s": 1.0}, "trace": None}) is None
