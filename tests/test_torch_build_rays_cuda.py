"""A round's NOF rays built on the card (``ops/build_rays_cuda.py``,
``csrc/build_rays.cu``) on the CPU: the kernels' source built for the host
and driven by the wrapper's own ``compute`` against the host twin
(``NofRunner._build_all_rays`` on the CPU), row for row and bit for bit,
on the joint60 traffic's cube keyframes and on hard frames; the pool
written from the card's rows through growth and capped rounds; the routing
by device; the C entry points' ctypes signatures; and the
``ray_build_device_per_frame`` reader.  ``chip_smoke.py``'s ``build_rays``
phase holds the kernels themselves to the twin on the card, on every
joint60 keyframe.

This file imports nothing of the JAX package.
"""
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from port_build_rays_kernel import (REPO, SOURCE, hard_inputs, host_launch, joint60_inputs,
                                    nof_cfg, run_on_host)
from bundlesdf_tpu_torch.config import Cfg
from bundlesdf_tpu_torch.nof import render as trender
from bundlesdf_tpu_torch.nof.runner import NofRunner
from bundlesdf_tpu_torch.ops import _cuda_lib
from bundlesdf_tpu_torch.ops import build_rays_cuda as br
from bundlesdf_tpu_torch.utils import profiler

SEED = 2147483001


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernels' source for the host")
    return host_launch(str(tmp_path_factory.mktemp("build_rays_kernel")))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The device steps replaced by the host: the launches run the kernels'
    source, the upload is the wrapper's packing into a CPU tensor; returns
    the stand-in, whose ``batches`` lists each batch's frame ids."""
    monkeypatch.setattr(_cuda_lib, "launch", host_lib)
    run = run_on_host()
    monkeypatch.setattr(br, "_run_kernel", run)
    profiler.reset()
    yield run
    profiler.reset()


def _runner(data: dict, n: int, occ: bool = False, **over) -> NofRunner:
    cfg = Cfg.wrap(nof_cfg(sc_factor=data["sc"], **over))
    return NofRunner(cfg, data["images"][:n], data["depths"][:n], data["masks"][:n],
                     data["poses"][:n], data["K"], data["pcd"],
                     occ_masks=data["occ"][:n] if occ else None, device="cpu")


def _card_rows(runner: NofRunner, fids) -> np.ndarray:
    """The rows the kernels build for ``fids``, written into a fresh array."""
    rays = runner._build_rays_on_card(list(fids))
    out = torch.full((len(rays), trender.RAY_DIM), np.nan)
    rays.write(out)
    return out.numpy()


def _assert_same_rows(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def cube():
    return (joint60_inputs(3, 240, 320, SEED), joint60_inputs(2, 480, 640, SEED, first=30))


@pytest.mark.parametrize("size", [0, 1], ids=["240x320", "480x640"])
def test_kernels_on_the_host_are_the_twin_on_cube_frames(on_host, cube, size):
    """The joint60 traffic's cube keyframes as the joint loop preprocesses
    them (frame 0's 100-px dilation, the later frames' 60 px, the denoise
    against the fused cloud): the kernels' rows are the twin's, bit for
    bit and in its order, for the first round's frames and for a later
    round's; one batch a call."""
    data = cube[size]
    n = len(data["images"])
    runner = _runner(data, n)
    assert runner.n_rays > 1000 * n
    _assert_same_rows(_card_rows(runner, range(n)), runner.rays_np)
    _assert_same_rows(_card_rows(runner, range(1, n)), runner._build_all_rays(range(1, n)))
    assert on_host.batches == [list(range(n)), list(range(1, n))]
    st = profiler.stats()
    assert st["nof/build_rays_device_frames"]["count"] == 2 * n - 1
    # select, two scans (the cloud grid's and the flags'), the grid's cells
    # and fill, the flags, the write: 7 host calls a batch
    assert st["launch/build_rays"]["count"] == 14


def _hard(**over) -> dict:
    data = hard_inputs(96, 128, seed=11)
    data.update(over)
    return data


# (name, inputs, runner options)
HARD = {
    "all_rules": (lambda: _hard(), {"occ": True}),
    "no_occlusion_valid_depth_off": (lambda: _hard(), {"rays_valid_depth_only": False}),
    "empty_grid": (lambda: _hard(pcd=_hard()["pcd"] + np.float32(5.0)), {"occ": True}),
    "empty_cloud_denoise_off": (lambda: _hard(pcd=np.zeros((0, 3), np.float32)),
                                {"denoise_depth_use_octree_cloud": False}),
}


@pytest.mark.parametrize("case", list(HARD))
def test_kernels_on_the_host_are_the_twin_on_hard_frames(on_host, case):
    """A sphere seen by five cameras (``hard_inputs``): frame 0's 100-px
    dilation against the others' 20 px (down_scale_ratio 3), a mask on the
    image border, an empty mask, cameras on the box's face and edge (rays
    grazing, missing and starting on the box), invalid depth, an occlusion
    band; with and without the occlusion masks and rays_valid_depth_only,
    with every cloud point outside the box (an empty occupancy grid), and
    with an empty cloud and the denoise off: the twin's rows, bit for bit,
    for all five frames in one batch and for each frame alone."""
    make, opts = HARD[case]
    data = make()
    opts = dict(opts)
    occ = opts.pop("occ", False)
    runner = _runner(data, 5, occ=occ, down_scale_ratio=3,
                     octree_smallest_voxel_size=0.0016, octree_dilate_size=0.0016, **opts)
    _assert_same_rows(_card_rows(runner, range(5)), runner.rays_np)
    for f in range(5):
        _assert_same_rows(_card_rows(runner, [f]), runner._build_all_rays([f]))
    if case == "empty_grid":
        assert runner.n_rays == 0 and not runner.occ_grid.any()
    elif case == "empty_cloud_denoise_off":
        # the runner's cloud is then the origin alone: rays through its cells
        assert 0 < runner.n_rays < 1000
    else:
        assert runner.n_rays > 1000
        frames = runner.rays_np[:, trender.RAY_FRAME_ID]
        assert set(np.unique(frames)) == {0.0, 1.0, 3.0, 4.0}   # frame 2's mask is empty
        assert (runner.rays_np[:, trender.RAY_MASK] == 0).any()
    if case == "all_rules":
        assert runner.occ_resolution == 128 and runner.rcfg.n_march == 256
        near = runner.rays_np[:, trender.RAY_NEAR]
        assert (near == 0).any() and (near > 0).any()          # rays that start on the box


def test_the_hard_frames_reach_the_rules_edges(on_host):
    """The hard inputs do what ``hard_inputs`` says: the denoise decides
    some rows at exactly the radius (kept) and an ulp past it (dropped),
    some cloud points lie on the denoise grid's cell faces, a mask touches
    the border, the two dilations differ, and a frame gives one row alone
    (numpy's one-row matrix product)."""
    data = _hard()
    runner = _runner(data, 5, occ=True, down_scale_ratio=3,
                     octree_smallest_voxel_size=0.0016, octree_dilate_size=0.0016,
                     denoise_depth_use_octree_cloud=False)
    rows = runner.rays_np
    d = rows[:, trender.RAY_DIR] * rows[:, trender.RAY_DEPTH][:, None]
    pose = runner.c2w_np[rows[:, trender.RAY_FRAME_ID].astype(np.int32)]
    q = np.einsum("nab,nb->na", pose[:, :3, :3], d) + pose[:, :3, 3]
    dist, _ = cKDTree(data["pcd"]).query(q, k=1)
    ok = (rows[:, trender.RAY_MASK] > 0) & (rows[:, trender.RAY_DEPTH] <= 2.0 * data["sc"])
    radius = 0.02 * data["sc"]
    assert radius == 0.25
    assert (ok & (dist == radius)).any() and (ok & (dist > radius) & (dist < 0.2501)).any()
    cell = radius * br.CELL_MARGIN
    lo = data["pcd"].min(0).astype(np.float64) - cell
    t = (data["pcd"].astype(np.float64) - lo) / cell
    assert (t == np.round(t)).all(axis=1).sum() >= 100
    masks = data["masks"] > 0
    assert masks[1][:, -1].any() or masks[1][-1].any() or masks[1][0].any() or masks[1][:, 0].any()
    assert runner._mask_dilation(0) == 100 and runner._mask_dilation(1) == 20
    # one candidate row in a frame: numpy multiplies it by the pose through
    # sgemv, which rounds unlike sgemm
    _assert_same_rows(*_one_row_frames())


def _one_row_frames():
    """Twenty frames of one candidate row each (every other pixel masked at
    an invalid depth, so dropped as type 1), a sphere pixel at its depth
    seen by hard frame 0's or 1's camera; the kernels' rows and the twin's."""
    data = _hard()
    rng = np.random.default_rng(5)
    n = 20
    src = np.arange(n) % 2
    one = {"images": data["images"][src], "masks": np.ones_like(data["masks"][src]),
           "depths": np.full_like(data["depths"][src], 0.5), "poses": data["poses"][src],
           "K": data["K"], "pcd": data["pcd"], "sc": data["sc"]}
    for f in range(n):
        v, u = np.nonzero((data["masks"][src[f]] > 0) & (data["depths"][src[f]] > 1.3)
                          & (data["depths"][src[f]] < 20.0))
        j = rng.integers(len(v))
        one["depths"][f, v[j], u[j]] = data["depths"][src[f], v[j], u[j]]
    single = _runner(one, n)
    assert all(len(single._build_frame_rays(f)) == 1 for f in range(n))
    assert single.n_rays > n // 2
    return _card_rows(single, range(n)), single.rays_np


def test_pool_takes_the_card_rows_through_growth_and_cap(on_host, cube, monkeypatch):
    """A runner whose rounds are built by the kernels, through its first
    round, a pool that grows and capped rounds (ray_pool_max_log2 16):
    after every round its pool is the twin runner's, bit for bit, in the
    same storage once capped."""
    small = cube[0]
    twin = _runner(small, 1, ray_pool_max_log2=16)
    card = _runner(small, 1, ray_pool_max_log2=16)
    monkeypatch.setattr(card, "_build_all_rays", lambda ids: card._build_rays_on_card(list(ids)))
    for r in (twin, card):
        r._upload_rays(r._build_all_rays(range(1)), keep=0)
    _assert_same_rows(card.rays_np, twin.rays_np)
    ptrs = []
    for k in range(1, 3):
        for r in (twin, card):
            r.add_new_frames(small["images"][k:k + 1], small["depths"][k:k + 1],
                             small["masks"][k:k + 1], small["poses"][:k + 1], small["pcd"])
        _assert_same_rows(card.rays_np, twin.rays_np)
        np.testing.assert_array_equal(card.rays_dev.numpy(), twin.rays_dev.numpy())
        ptrs.append(card.rays_dev.data_ptr())
    assert card.n_rays == 1 << 16 and ptrs[0] == ptrs[1]
    assert profiler.stats()["nof/pool_subsample"]["count"] == 4


def test_cpu_route_is_the_twin(monkeypatch):
    """On the CPU the twin builds the rays and nothing launches."""
    monkeypatch.setattr(br, "_run_kernel", lambda *a: pytest.fail("the kernel ran"))
    before = br.launches
    data = _hard()
    runner = _runner(data, 2)
    rows = runner._build_all_rays(range(2))
    assert isinstance(rows, np.ndarray) and len(rows) == runner.n_rays
    assert br.launches == before


def test_a_cuda_device_takes_the_kernel(monkeypatch):
    """On a CUDA device ``_build_all_rays`` hands every frame to the kernel
    in one call under ``nof/build_rays/device`` and returns its ``Rays``;
    no frames is the twin's empty array (no card needed: the launch is
    replaced)."""
    data = _hard()
    runner = _runner(data, 3)
    calls = []

    def fake(dev, frames, fids, poses, dilations, rules, dirs, grid, cloud, cloud_dev):
        calls.append((dev.type, list(fids), list(dilations), rules))
        np.testing.assert_array_equal(poses, runner.c2w_np[fids])
        assert frames[0] is runner._images and frames[3] is None
        assert grid is runner.occ_grid and cloud is runner._build_pts
        assert dirs is runner._dirs_dev
        return br.Rays({}, 7)

    monkeypatch.setattr(br, "_run_kernel", fake)
    monkeypatch.setattr(runner, "device", torch.device("cuda", 0))
    runner._dirs_dev = torch.zeros(1)     # as cached on the card by an earlier round
    profiler.reset()
    rays = runner._build_all_rays(range(3))
    assert isinstance(rays, br.Rays) and len(rays) == 7
    sc = data["sc"]
    want = br.Rules(near_sc=0.1 * sc, far_sc=2.0 * sc, radius=0.02 * sc, n_march=128,
                    valid_depth_only=True, denoise=True)
    assert calls == [("cuda", [0, 1, 2], [100, 60, 60], want)]
    st = profiler.stats()
    assert st["nof/build_rays/device"]["count"] == 1
    assert st["nof/build_rays/device"]["parents"] == {"nof/build_rays": 1}
    assert st["nof/build_rays_device_frames"]["count"] == 3
    empty = runner._build_all_rays(range(0))
    assert isinstance(empty, np.ndarray) and empty.shape == (0, trender.RAY_DIM)
    profiler.reset()


def test_rays_write_once_into_their_place(on_host):
    """``Rays.write`` takes a contiguous f32 (n, 12) place on its device,
    once."""
    data = _hard()
    runner = _runner(data, 1)
    rays = runner._build_rays_on_card([0])
    for bad in (torch.empty((len(rays) + 1, trender.RAY_DIM)),
                torch.empty((trender.RAY_DIM, len(rays))).T,
                torch.empty((len(rays), trender.RAY_DIM), dtype=torch.float64)):
        with pytest.raises(ValueError, match="x 12 on cpu expected"):
            rays.write(bad)
    rays.write(torch.empty((len(rays), trender.RAY_DIM)))
    with pytest.raises(RuntimeError, match="written already"):
        rays.write(torch.empty((len(rays), trender.RAY_DIM)))


@pytest.mark.parametrize("bad", ["upload", "dirs", "grid", "cloud"])
def test_compute_refuses_inputs_that_do_not_match(bad):
    """``compute`` passes pointers only to buffers of the batch's shapes and
    dtypes: a short upload, directions of another size, a grid that is not
    a cube, a cloud copy of another length raise before any launch."""
    H, W, B = 6, 8, 2
    _, _, total = br.layout(B, H, W)
    args = {"upload": torch.zeros(total, dtype=torch.uint8),
            "dirs": torch.zeros((H, W, 3)), "grid": torch.zeros((4, 4, 4), dtype=torch.bool),
            "cloud": torch.zeros((5, 3))}
    args[bad] = {"upload": torch.zeros(total - 1, dtype=torch.uint8),
                 "dirs": torch.zeros((H, W + 1, 3)),
                 "grid": torch.zeros((4, 4, 2), dtype=torch.bool),
                 "cloud": torch.zeros((4, 3))}[bad]
    rules = br.Rules(1.0, 20.0, 0.25, 128, True, True)
    before = br.launches
    with pytest.raises(ValueError, match="do not match the batch"):
        br.compute(args["upload"], B, H, W, False, rules, args["dirs"], args["grid"],
                   np.zeros((5, 3), np.float32), args["cloud"])
    assert br.launches == before


def test_ctypes_signatures_match_the_c_entry_points():
    """``_SIGNATURES`` has one ctypes type of the right width per parameter
    of each C entry point, the stream last; the source is built and its
    wrapper's launches counted; the wrapper's scan tile and parameter words
    are the source's."""
    src = open(SOURCE).read()
    kinds = {"int": _cuda_lib._I, "float": _cuda_lib._F, "double": _cuda_lib._D,
             "long": _cuda_lib._L}
    names = re.findall(r'extern "C" int (build_rays_\w+)\(', src)
    assert sorted(names) == sorted(n for n in _cuda_lib._SIGNATURES if n.startswith("build_"))
    assert len(names) == 6
    for name in names:
        params = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S).group(1)
        want = [_cuda_lib._P if "*" in p else kinds[p.split()[0]] for p in params.split(",")]
        assert list(_cuda_lib._SIGNATURES[name]) == want, name
    assert "build_rays.cu" in _cuda_lib.SOURCES and "build_rays_cuda" in _cuda_lib.COUNTED
    assert int(re.search(r"constexpr int kScanTile = (\d+);", src).group(1)) == br.SCAN_TILE
    assert int(re.search(r"constexpr int kParamWords = (\d+);", src).group(1)) == br.PARAM_WORDS


def _reader():
    path = os.path.join(REPO, "portbench", "metrics", "ray_build_device_per_frame.py")
    spec = importlib.util.spec_from_file_location("ray_build_device_per_frame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("count,frames,want", [(34, 34, 1.0), (17, 34, 0.5), (36, 34, 36 / 34)])
def test_ray_build_device_reader(count, frames, want):
    """The counter ``nof/build_rays_device_frames`` over the window's frames;
    None where the program has no such counter, or the run no frames."""
    read = _reader()
    counter = {"count": count, "total_s": 0.0, "mean_s": 0.0, "max_s": 0.0, "self_s": 0.0,
               "parents": {}}
    spans = {"nof/build_rays": {"count": frames, "total_s": 1.0, "mean_s": 0.03,
                                "max_s": 0.05, "self_s": 0.1,
                                "parents": {"nof/add_new_frames": frames}},
             "nof/build_rays_device_frames": counter}
    assert read({"record": {"frames": frames, "spans": spans}, "trace": None}) == want
    parent = {k: v for k, v in spans.items() if k != "nof/build_rays_device_frames"}
    assert read({"record": {"frames": frames, "spans": parent}, "trace": None}) is None
    assert read({"record": {"frames": 0, "spans": spans}, "trace": None}) is None
    assert read({"record": {"steps": 100, "window_s": 1.0}, "trace": None}) is None
