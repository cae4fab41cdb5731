"""The tracker's covisibility kernel (``ops/covisibility_cuda.py``,
``csrc/covisibility.cu``) on the CPU: the kernel's source built for the
host against the numpy twin and a float64 count, the wrapper's routing and
its threshold, the C entry point's ctypes signature, and the Bundler's
batched covisibility against the JAX Bundler's per-pair loop, on both
routes.  The card runs the kernel itself in ``chip_smoke.py``'s
``covisibility`` phase.

Why the kernel's count may differ from the twin's: the twin's ``@`` is
BLAS's sgemm, which sums its three products in an order of its own choosing
(the kernel takes the order OpenBLAS takes: a product, then two fused
multiply-adds), so a point can flip only where its dot lies within f32
rounding of the threshold.  A dot of norm-1 vectors computed from f32
inputs carries a few ulps of 1 (~1e-7) of error, so 1e-5 bounds the points
that can flip with a hundredfold margin.
"""
import re
import shutil
import types

import numpy as np
import pytest
import torch

from port_covisibility_kernel import (SOURCE, f64_count, hard_frames, hard_queries,
                                      host_kernel, make_frame, near_threshold)
from synthetic_cube import make_cube_sequence
from bundlesdf_tpu.config import default_track_config as jax_track_cfg
from bundlesdf_tpu.tracking import frame as jframe
from bundlesdf_tpu.tracking.pool import Bundler as JBundler
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.ops import _cuda_lib
from bundlesdf_tpu_torch.ops import covisibility_cuda as cov
from bundlesdf_tpu_torch.tracking import frame as tframe
from bundlesdf_tpu_torch.tracking.pool import Bundler as TBundler
from bundlesdf_tpu_torch.utils import profiler

ANGLE = 70.0


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    return host_kernel(str(tmp_path_factory.mktemp("covisibility_kernel")))


@pytest.fixture
def on_host(host_run, monkeypatch):
    """The wrapper's two device steps replaced by the host: the upload
    keeps the packed maps in CPU tensors, the launch runs the kernel's
    source; returns the frames each upload was given."""
    uploads = []

    def device_maps(dev, frames):
        uploads.append([f.id for f in frames])
        out = []
        for f in frames:
            buf = np.zeros(cov.POINT_BYTES * cov.n_points(f), np.uint8)
            cov.pack_maps(f, buf)
            out.append(torch.from_numpy(buf))
        return out

    def count(dev, maps, sizes, q_begin, rel, thres):
        assert dev.type == "cuda"
        cov.launches += 1
        return host_run([m.numpy() for m in maps], sizes, q_begin, rel, thres)

    monkeypatch.setattr(cov, "_device_maps", device_maps)
    monkeypatch.setattr(cov, "_count", count)
    return uploads


def _twin_count(fa, fb) -> int:
    total = int((fa.valid & fa.fg_mask)[::2, ::2].sum())
    return int(round(tframe.compute_covisibility(fa, fb, ANGLE) * (total + 1e-7)))


def _kernel_counts(pairs, angle=ANGLE) -> list:
    """Each pair's count from the wrapper's ratio and A's total."""
    got = cov.covisibilities(pairs, angle, "cuda", {})
    return [int(round(v * (int((fa.valid & fa.fg_mask)[::2, ::2].sum()) + 1e-7)))
            for v, (fa, _) in zip(got, pairs)]


@pytest.mark.parametrize("shape,n_random", [((96, 128), 70), ((70, 100), 12), ((21, 33), 5)])
def test_kernel_source_on_the_host_matches_the_twin(on_host, shape, n_random):
    """The hard frames (a plane at the visible angle, a sphere's outside and
    inside, a step with noisy normals; holes and fg gaps) under identity,
    opposite and random poses, in one launch: each count is the twin's, or
    off by at most the points whose float64 dot lies within 1e-5 of the
    threshold, and as near the float64 count.  At (96, 128) a frame has 72
    queries, more than one block stages at once (kQueryChunk)."""
    frames = hard_frames(*shape, seed=sum(shape))
    pairs = hard_queries(frames, n_random, seed=n_random)
    got = _kernel_counts(pairs)
    n_near = 0
    for k, (fa, fb) in enumerate(pairs):
        near = near_threshold(fa, fb, ANGLE)
        twin = _twin_count(fa, fb)
        assert abs(got[k] - twin) <= near, (k, got[k], twin, near)
        assert abs(got[k] - f64_count(fa, fb, ANGLE)) <= near, k
        n_near += near
    assert n_near > 0.1 * shape[0] * shape[1] / 4      # the plane tests the threshold
    # the identity query counts every point facing the eye, the opposite one few
    for fa in frames:
        ks = [k for k, p in enumerate(pairs) if p[0] is fa]
        assert got[ks[0]] > got[ks[1]]
    assert len(on_host) == 1 and on_host[0] == [f.id for f in frames]


def test_kernel_source_on_the_host_matches_the_twin_on_the_cube(on_host):
    """Every ordered pair of the cube's Frames at their true poses: the
    ratios are the twin's floats."""
    data = make_cube_sequence(n_frames=6, deg_per_frame=12.0)
    cfg = default_track_config()
    frames = [tframe.Frame(data["colors"][k], data["depths"][k], data["K"], k, str(k), cfg,
                           pose_in_model=np.linalg.inv(data["gt_ob_in_cam"][k]),
                           fg_mask=data["masks"][k]) for k in range(6)]
    pairs = [(a, b) for a in frames for b in frames]
    got = cov.covisibilities(pairs, ANGLE, "cuda", {})
    want = [tframe.compute_covisibility(a, b, ANGLE) for a, b in pairs]
    assert got == want
    assert 0 < sum(0 < v < 1 for v in want) and min(want) == 0.0


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_cpu_route_is_the_twin(device, monkeypatch):
    """On a CPU device the wrapper is the twin, pair by pair, and launches
    nothing."""
    frames = hard_frames(24, 32, seed=1)
    pairs = hard_queries(frames, 3, seed=2)
    monkeypatch.setattr(cov, "_run_kernel", lambda *a: pytest.fail("the kernel ran"))
    before = cov.launches
    resident = {}
    got = cov.covisibilities(pairs, ANGLE, device, resident)
    assert got == [tframe.compute_covisibility(a, b, ANGLE) for a, b in pairs]
    assert cov.launches == before and resident == {}


def test_a_cuda_device_takes_the_kernel(monkeypatch):
    """On a CUDA device the wrapper hands every pair to one launch and
    counts ``launch/covisibility`` and ``readback/covisibility`` once (no
    card needed: the launch is replaced)."""
    calls = []
    monkeypatch.setattr(cov, "_run_kernel",
                        lambda dev, pairs, angle, resident: calls.append(
                            (dev, len(pairs), angle)) or [0.5] * len(pairs))
    profiler.reset()
    pairs = hard_queries(hard_frames(8, 8, seed=3), 2, seed=4)
    assert cov.covisibilities(pairs, ANGLE, "cuda", {}) == [0.5] * len(pairs)
    assert calls == [(torch.device("cuda"), len(pairs), ANGLE)]
    st = profiler.stats()
    assert st["launch/covisibility"]["count"] == st["readback/covisibility"]["count"] == 1


@pytest.mark.parametrize("angle", [70.0, 0.0, 30.0, 45.0, 60.0, 89.9, 90.0, 120.0])
def test_threshold_is_numpys_comparison(angle):
    """``dot > threshold(angle)`` in f32 is the twin's ``dots > np.cos(
    np.deg2rad(angle))`` on every f32 near the threshold, whatever precision
    numpy compares in."""
    thres = np.cos(np.deg2rad(angle))
    t = cov.threshold(angle)
    assert np.float32(t) == t
    c = np.float32(thres)
    near = np.array([c], np.float32)
    for _ in range(8):
        near = np.concatenate([np.nextafter(near, np.float32(-2)), near,
                               np.nextafter(near, np.float32(2))])
    near = np.unique(near)
    np.testing.assert_array_equal(near > np.float32(t), near > thres)


def test_pack_maps_holds_the_twins_arrays():
    """The packed bytes are the stride-2 xyz and normals as planes and
    ``valid & fg_mask``, at odd sizes too."""
    for H, W in ((21, 33), (8, 8)):
        fa = hard_frames(H, W, seed=5)[0]
        buf = np.zeros(cov.POINT_BYTES * cov.n_points(fa), np.uint8)
        cov.pack_maps(fa, buf)
        P = cov.n_points(fa)
        assert P == ((H + 1) // 2) * ((W + 1) // 2)
        planes = buf[:24 * P].view(np.float32).reshape(6, P)
        np.testing.assert_array_equal(planes[:3].T, fa.xyz[::2, ::2].reshape(-1, 3))
        np.testing.assert_array_equal(planes[3:].T, fa.normals[::2, ::2].reshape(-1, 3))
        np.testing.assert_array_equal(buf[24 * P:].view(np.bool_),
                                      (fa.valid & fa.fg_mask)[::2, ::2].reshape(-1))


def test_ctypes_signature_matches_the_c_entry_point():
    """``_SIGNATURES['covisibility_count_f32']`` has one ctypes type of the
    right width per parameter of the C function, the stream last; the
    source is built and its wrapper's launches counted; a block's staged
    queries fit its static shared memory."""
    src = open(SOURCE).read()
    params = re.search(r'extern "C" int covisibility_count_f32\((.*?)\)\s*\{', src,
                       re.S).group(1)
    kinds = {"int": _cuda_lib._I, "float": _cuda_lib._F, "double": _cuda_lib._D}
    want = [_cuda_lib._P if "*" in p else kinds[p.split()[0]] for p in params.split(",")]
    assert list(_cuda_lib._SIGNATURES["covisibility_count_f32"]) == want
    assert "covisibility.cu" in _cuda_lib.SOURCES and "covisibility_cuda" in _cuda_lib.COUNTED
    chunk = int(re.search(r"constexpr int kQueryChunk = (\d+);", src).group(1))
    assert chunk * (12 + 1) * 4 <= 48 * 1024


# --------------------------------------------------------------- Bundler ---

METHODS = ["normal_orientation_nearest", "normal_orientation_greedy",
           "greedy_covisible_points", "max_edge"]


@pytest.fixture(scope="module")
def cube9():
    return make_cube_sequence(n_frames=10, deg_per_frame=9.0)


def _cube_pool(module, bundler_cls, method, data, kw, route=None):
    """A pool of the cube's Frames 0-8 at their true poses (frame 3's made
    the identity, so the pair enumeration skips it), frame 9 new: the BA
    subset over 4 frames, the fresh pairs, their skip marks, and the
    admission of frames 4 and 9 again under ``min_visible`` 0.9."""
    cfg = jax_track_cfg() if module is jframe else default_track_config()
    cfg["bundle"]["max_BA_frames"] = 4
    cfg["bundle"]["subset_selection_method"] = method
    cfg["bundle"]["non_neighbor_min_visible"] = 0.1
    cfg["keyframe"]["min_visible"] = 0.9
    cfg["keyframe"]["min_rot"] = 0.0
    b = bundler_cls(cfg, **kw)
    if route is not None:
        b.device = torch.device(route)
    frames = [module.Frame(data["colors"][k], data["depths"][k], data["K"], k, str(k), cfg,
                           pose_in_model=np.linalg.inv(data["gt_ob_in_cam"][k]).astype(
                               np.float32), fg_mask=data["masks"][k]) for k in range(10)]
    frames[3].pose_in_model = np.eye(4, dtype=np.float32)
    b.firstframe = frames[0]
    b.keyframes = list(frames[:9])
    b.newframe = frames[9]
    b.select_keyframes_for_ba()
    local = [f.id for f in b.local_frames]
    everyone = sorted(frames, key=lambda f: f.id)
    pairs = [(a.id, c.id) for a, c in b.get_feature_match_pairs(everyone)]
    skips = sorted(k for k, v in b.store.matches.items() if v is None)
    b.keyframes = [frames[0], frames[2]]
    twins = [module.Frame(data["colors"][k], data["depths"][k], data["K"], 20 + k, str(k),
                          cfg, pose_in_model=np.linalg.inv(data["gt_ob_in_cam"][k]).astype(
                              np.float32), fg_mask=data["masks"][k]) for k in (4, 9)]
    admitted = [b.check_and_add_keyframe(f) for f in twins]
    return {"local": local, "pairs": pairs, "skips": skips, "admitted": admitted}


@pytest.mark.parametrize("method", METHODS)
def test_batched_selection_equals_the_per_pair_loop(cube9, method, on_host):
    """On the cube, the port's Bundler on both routes (the CPU twin, and a
    CUDA tracker with the kernel's source run on the host) chooses the BA
    subset, the fresh pairs, the skip marks and the admissions the JAX
    Bundler's per-pair loop over ``compute_covisibility`` chooses; both
    routes compute the same pairs, and the kernel route one launch a
    ``track/covisibility`` batch."""
    want = _cube_pool(jframe, JBundler, method, cube9, {})
    assert want["pairs"] and want["skips"] and True in want["admitted"]
    seen = {}
    for route in ("cpu", "cuda"):
        profiler.reset()
        got = _cube_pool(tframe, TBundler, method, cube9, {"device": "cpu"},
                         None if route == "cpu" else route)
        assert got == want, route
        st = profiler.stats()
        seen[route] = (st["track/covisibility"]["count"],
                       st["track/covisibility_pairs"]["count"])
        if route == "cuda":
            assert st["launch/covisibility"]["count"] == st["track/covisibility"]["count"]
            assert st["readback/covisibility"]["count"] == st["track/covisibility"]["count"]
        else:
            assert "launch/covisibility" not in st
    assert seen["cpu"] == seen["cuda"]
    assert seen["cpu"][1] > seen["cpu"][0]


def test_a_frame_changed_after_its_upload_is_uploaded_again(cube9, on_host):
    """A CUDA tracker uploads a Frame queried as A once; a change to its
    maps bumps its version, and its next query uploads it again and counts
    the new maps; ``forget_frame`` frees its copy."""
    cfg = default_track_config()
    b = TBundler(cfg, device="cpu")
    b.device = torch.device("cuda")
    f = [tframe.Frame(cube9["colors"][k], cube9["depths"][k], cube9["K"], k, str(k), cfg,
                      pose_in_model=np.linalg.inv(cube9["gt_ob_in_cam"][k]).astype(np.float32),
                      fg_mask=cube9["masks"][k]) for k in range(4)]
    before = [tframe.compute_covisibility(f[3], f[k]) for k in (0, 1)]
    assert b.covisibilities([(f[3], f[0]), (f[3], f[1])]) == before
    assert on_host == [[3]] and b._cov_maps[3][:2] == (f[3], 0)
    b.covisibility(f[3], f[2])
    assert on_host == [[3]]
    keep = np.ones((96, 96), bool)
    keep[:, :48] = False
    f[3].invalidate_pixels_by_mask(keep)
    assert f[3].version == 1
    assert b.covisibility(f[3], f[1]) == before[1]    # cached before the change
    b._cov_cache = {}
    v = b.covisibility(f[3], f[1])
    assert on_host == [[3], [3]] and b._cov_maps[3][1] == 1
    assert v == tframe.compute_covisibility(f[3], f[1]) != before[1]
    f[3].point_cloud_denoise()
    assert f[3].version == 2
    b.covisibility(f[3], f[0])
    assert on_host == [[3], [3], [3]]
    b.frames[3] = f[3]
    assert b.forget_frame(f[3])
    assert 3 not in b._cov_maps
    assert all(3 not in k for k in b._cov_cache)
