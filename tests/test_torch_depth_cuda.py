"""The tracker's depth pipeline kernel (``ops/depth_cuda.py``,
``csrc/depth_frame.cu``) on the CPU: the wrapper's routing, the halo rule
against the kernel's tile, the C entry point's ctypes signature, the
kernel's source built for the host against the numpy twin bit for bit, the
Frame on both routes, and the ``depth_device_per_frame`` reader.  The card
runs the kernel itself in ``chip_smoke.py``'s ``depth_frame`` phase."""
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch

from port_depth_kernel import REPO, SOURCE, hard_depth_frames, hard_k, host_kernel
from synthetic_cube import make_cube_sequence
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.ops import _cuda_lib, depth_cuda
from bundlesdf_tpu_torch.ops import image as image_ops
from bundlesdf_tpu_torch.tracking import frame as frame_mod
from bundlesdf_tpu_torch.utils import profiler

PARAMS = dict(zfar=1.0, erode_radius=1, erode_diff=0.001, erode_ratio=0.8,
              bilateral_radius=2, sigma_d=2.0, sigma_r=100000.0,
              edge_normal_thres_deg=10.0)
# (erode, bilateral) radii: the shipped ones, wider ones within the tile's
# halo (the widest: 3 + 2 * 6 + 1 = 16), no bilateral smoothing
RADII = [(1, 2), (2, 4), (3, 6), (1, 0)]


def _params(radii):
    return dict(PARAMS, erode_radius=radii[0], bilateral_radius=radii[1])


def _assert_bitwise(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert got[3].dtype == want[3].dtype == np.bool_
    np.testing.assert_array_equal(got[3], want[3])


@pytest.fixture(scope="module")
def cube():
    return make_cube_sequence(n_frames=3, deg_per_frame=6.0)


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    return host_kernel(str(tmp_path_factory.mktemp("depth_kernel")))


def _parents_frame_maps(color, depth, K, cfg, fg_mask, occ_mask):
    """The maps and gray of the parent's Frame: the twin, then the fg and
    occ invalidation as its ``invalidate_pixels_by_mask`` wrote it."""
    d, xyz, nrm, valid = image_ops.process_depth_frame_np(
        depth, np.asarray(K, np.float32), **depth_cuda.config_params(cfg["depth_processing"]))
    H, W = d.shape
    masks = [np.ones((H, W), bool) if fg_mask is None else np.asarray(fg_mask) > 0]
    if occ_mask is not None:
        masks.append(~(np.asarray(occ_mask) > 0))
    for keep in masks:
        d = np.where(keep, d, 0.0)
        valid = valid & keep
        xyz = np.where(keep[..., None], xyz, 0.0)
        nrm = np.where(keep[..., None], nrm, 0.0)
    c = np.asarray(color, np.float32)
    gray = 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]
    return (d, xyz, nrm, valid), gray


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
@pytest.mark.parametrize("radii", [(1, 2), (2, 4), (2, 7)])
def test_cpu_route_is_the_twin_bitwise(cube, device, radii):
    """On a CPU device the wrapper is ``process_depth_frame_np`` itself,
    whatever the radii, and launches nothing."""
    before = depth_cuda.launches
    got = depth_cuda.process_depth_frame(cube["depths"][1], cube["K"], device, **_params(radii))
    want = image_ops.process_depth_frame_np(cube["depths"][1], cube["K"], **_params(radii))
    _assert_bitwise(got, want)
    assert depth_cuda.launches == before


def test_halo_rule_is_held_to_the_kernel_tile():
    """The wrapper's tile constants are the source's, and it takes the
    kernel exactly where the halo (erode + 2 bilateral + the normals' 1)
    fits the tile's: the largest halo's two shared buffers need no opt-in
    above 48 KB, and its bilateral weights fit the parameter block."""
    src = open(SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (depth_cuda.TILE_Y, depth_cuda.TILE_X, depth_cuda.MAX_HALO) == (
        const("kTileY"), const("kTileX"), const("kMaxHalo"))
    for e in range(-1, 12):
        for b in range(-1, 12):
            want = e >= 0 and b >= 0 and e + 2 * b + 1 <= depth_cuda.MAX_HALO
            assert depth_cuda.kernel_takes(e, b) == want, (e, b)
            if want:
                assert (2 * b + 1) ** 2 <= (2 * ((depth_cuda.MAX_HALO - 1) // 2) + 1) ** 2
    h = depth_cuda.MAX_HALO
    assert 2 * 4 * (depth_cuda.TILE_Y + 2 * h) * (depth_cuda.TILE_X + 2 * h) <= 48 * 1024
    assert depth_cuda.halo(1, 2) == 6


def test_a_cuda_device_takes_the_kernel_within_the_halo(cube, monkeypatch):
    """On a CUDA device the wrapper launches within the halo, under the span
    ``track/depth/device``, and takes the twin beyond it (no card needed:
    the launch is replaced)."""
    calls = []
    monkeypatch.setattr(depth_cuda, "_run_kernel",
                        lambda *a: calls.append(a) or ("kernel",))
    profiler.reset()
    assert depth_cuda.process_depth_frame(cube["depths"][1], cube["K"], "cuda",
                                          **PARAMS) == ("kernel",)
    assert len(calls) == 1 and calls[0][0] == torch.device("cuda")
    assert profiler.stats()["track/depth/device"]["count"] == 1
    got = depth_cuda.process_depth_frame(cube["depths"][1], cube["K"], "cuda",
                                         **_params((2, 7)))
    _assert_bitwise(got, image_ops.process_depth_frame_np(cube["depths"][1], cube["K"],
                                                          **_params((2, 7))))
    assert len(calls) == 1 and profiler.stats()["track/depth/device"]["count"] == 1


def test_ctypes_signature_matches_the_c_entry_point():
    """``_SIGNATURES['depth_frame_f32']`` has one ctypes type of the right
    width per parameter of the C function, the stream last."""
    src = open(SOURCE).read()
    params = re.search(r'extern "C" int depth_frame_f32\((.*?)\)\s*\{', src, re.S).group(1)
    kinds = {"int": _cuda_lib._I, "float": _cuda_lib._F, "double": _cuda_lib._D}
    want = [_cuda_lib._P if "*" in p else kinds[p.split()[0]] for p in params.split(",")]
    assert list(_cuda_lib._SIGNATURES["depth_frame_f32"]) == want
    assert "depth_frame.cu" in _cuda_lib.SOURCES and "depth_cuda" in _cuda_lib.COUNTED


@pytest.mark.parametrize("radii", RADII)
@pytest.mark.parametrize("shape", [(96, 128), (70, 100), (20, 30)])
def test_kernel_source_on_the_host_matches_the_twin_bitwise(host_run, shape, radii):
    """The kernel's source, built for the host with one thread a block,
    against the twin and the Frame's mask invalidation on the hard frames:
    depth, xyz and normals bit for bit and valid equal, with and without
    masks, on tiles cut by the image's edge."""
    p = _params(radii)
    K = hard_k(*shape)
    n_valid = 0
    for depth, fg, occ in hard_depth_frames(4, *shape, seed=sum(shape) + radii[1]):
        want = depth_cuda.process_depth_frame(depth, K, "cpu", fg, occ, **p)
        _assert_bitwise(host_run(depth, K, fg, occ, **p), want)
        n_valid += int(want[3].sum())
    assert n_valid > 0.3 * 4 * shape[0] * shape[1]


def test_kernel_source_on_the_host_matches_the_twin_on_the_cube(host_run, cube):
    """The same on the cube's rendered frames (mm-quantized depth, the
    object's mask) at the shipped radii."""
    for k in range(3):
        want = depth_cuda.process_depth_frame(cube["depths"][k], cube["K"], "cpu",
                                              cube["masks"][k], **PARAMS)
        _assert_bitwise(host_run(cube["depths"][k], cube["K"], cube["masks"][k], **PARAMS),
                        want)
        assert want[3].sum() > 500


@pytest.mark.parametrize("masks", ["none", "fg", "fg_occ"])
def test_frame_on_the_cpu_is_the_parents_frame_bitwise(cube, masks):
    """A Frame built on the CPU (the default device) has the maps and gray
    of the parent's Frame, bit for bit, and launches nothing."""
    cfg = default_track_config()
    fg = None if masks == "none" else cube["masks"][1]
    occ = None
    if masks == "fg_occ":
        occ = np.zeros((96, 96), np.uint8)
        occ[40:50, 30:70] = 255
    before = depth_cuda.launches
    f = frame_mod.Frame(cube["colors"][1], cube["depths"][1], cube["K"], 1, "1", cfg,
                        fg_mask=fg, occ_mask=occ)
    want, gray = _parents_frame_maps(cube["colors"][1], cube["depths"][1], cube["K"],
                                     cfg, fg, occ)
    _assert_bitwise((f.depth, f.xyz, f.normals, f.valid), want)
    np.testing.assert_array_equal(f.gray.view(np.uint32), gray.view(np.uint32))
    assert f.valid.sum() > 500 and depth_cuda.launches == before


def test_frame_on_a_cuda_device_takes_the_kernel(host_run, cube, monkeypatch):
    """A Frame given a CUDA device hands the kernel its raw depth, K, masks
    and config radii; with the kernel's source run on the host in the
    launch's place, its maps are the CPU Frame's bit for bit."""
    def launch(dev, depth, K, fg_mask, occ_mask, p):
        assert dev.type == "cuda" and K.dtype == np.float32
        return host_run(depth, K, fg_mask, occ_mask, **p)

    monkeypatch.setattr(depth_cuda, "_run_kernel", launch)
    cfg = default_track_config()
    occ = np.zeros((96, 96), np.uint8)
    occ[10:30, 20:60] = 1
    kw = dict(fg_mask=cube["masks"][2], occ_mask=occ)
    f_gpu = frame_mod.Frame(cube["colors"][2], cube["depths"][2], cube["K"], 2, "2", cfg,
                            device="cuda", **kw)
    f_cpu = frame_mod.Frame(cube["colors"][2], cube["depths"][2], cube["K"], 2, "2", cfg, **kw)
    _assert_bitwise((f_gpu.depth, f_gpu.xyz, f_gpu.normals, f_gpu.valid),
                    (f_cpu.depth, f_cpu.xyz, f_cpu.normals, f_cpu.valid))


def _reader():
    path = os.path.join(REPO, "portbench", "metrics", "depth_device_per_frame.py")
    spec = importlib.util.spec_from_file_location("depth_device_per_frame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("count,frames,want", [(40, 40, 1.0), (20, 40, 0.5), (7, 7, 1.0)])
def test_depth_device_reader(count, frames, want):
    """One ``track/depth/device`` span a frame reads 1.0; none, or no frame,
    reads None."""
    read = _reader()
    span = {"count": count, "total_s": 0.01 * count, "mean_s": 0.01, "max_s": 0.02,
            "self_s": 0.01 * count, "parents": {"track/make_frame": count}}
    spans = {"track/make_frame": dict(span, parents={None: count}),
             "track/depth/device": span}
    assert read({"record": {"frames": frames, "spans": spans}, "trace": None}) == want
    twin = {k: v for k, v in spans.items() if k != "track/depth/device"}
    assert read({"record": {"frames": frames, "spans": twin}, "trace": None}) is None
    assert read({"record": {"frames": 0, "spans": spans}, "trace": None}) is None
    assert read({"record": {"steps": 100, "window_s": 1.0}, "trace": None}) is None
