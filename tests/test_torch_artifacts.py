"""The port's artifact trail against the JAX package's: the PNG codec that
stands in for OpenCV (round trips, and PNGs that cv2 wrote with every
filter type), trails written by one package and read by the other, the
config files' YAML round trip, and ``BundleSdf(save_artifacts=True)``."""
import struct
import types
import zlib

import cv2
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from test_pipeline import small_track_cfg
from bundlesdf_tpu import config as jconfig
from bundlesdf_tpu.pipeline import artifacts as jart
from bundlesdf_tpu_torch import config as tconfig
from bundlesdf_tpu_torch.io.png import read_png, write_png
from bundlesdf_tpu_torch.pipeline import artifacts as tart
from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

torch.set_num_threads(2)


def _images(seed=0, H=48, W=64):
    """Seeded images of each format the trail writes: smooth ramps next to
    noise, so that libpng's adaptive filtering picks every filter type."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.stack([(2 * xx + yy) % 256, (3 * yy) % 256, (xx * yy) % 256], -1)
    rgb[H // 3: 2 * H // 3] = rng.integers(0, 256, (2 * H // 3 - H // 3, W, 3))
    gray16 = (xx * 700 + yy * 13).astype(np.uint16)
    gray16[H // 2:] = rng.integers(0, 65536, (H - H // 2, W))
    mask = (((xx - W / 2) ** 2 + (yy - H / 2) ** 2) < (H / 3) ** 2).astype(np.uint8) * 255
    return {"rgb8": rgb.astype(np.uint8), "gray16": gray16, "gray8": mask}


def _filter_types(path) -> set:
    """The filter type byte of each row of a PNG file."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    W, H, depth, ctype = hdr[:4]
    stride = W * {0: 1, 2: 3}[ctype] * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, stride + 1)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "gray8"])
def test_png_round_trip(tmp_path, kind):
    img = _images()[kind]
    path = str(tmp_path / f"{kind}.png")
    write_png(path, img)
    back = read_png(path)
    assert back.dtype == img.dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    # the file is a standard PNG: cv2 reads the same pixels (BGR order)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ref[..., ::-1] if img.ndim == 3 else ref, img)


@pytest.mark.parametrize("level", [1, 9])
def test_png_reads_what_cv2_wrote(tmp_path, level):
    """cv2 with an explicit compression level filters each row adaptively;
    the three files together use all five filter types."""
    seen = set()
    for kind, img in _images(seed=level).items():
        path = str(tmp_path / f"{kind}.png")
        cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img,
                    [cv2.IMWRITE_PNG_COMPRESSION, level])
        seen |= _filter_types(path)
        np.testing.assert_array_equal(read_png(path), img)
    assert seen == {0, 1, 2, 3, 4}, seen


def _fake_frames(n=3, H=40, W=56, seed=0):
    """Frames and a tracker with the attributes the trail reads."""
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3) * 0.1
        mask = np.zeros((H, W), bool)
        mask[5 + k: 30, 8: 40 + k] = True
        frames.append(types.SimpleNamespace(
            id_str=f"{k:05d}", pose_in_model=pose, nerfed=bool(k % 2),
            color=rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
            depth=np.where(mask, rng.uniform(0.3, 0.9, (H, W)), 0.0).astype(np.float32),
            fg_mask=mask))
    tracker = types.SimpleNamespace(bundler=types.SimpleNamespace(keyframes=frames))
    return tracker, frames


def _assert_frames_equal(a, b):
    assert [f["id_str"] for f in a] == [f["id_str"] for f in b] and len(a) > 0
    for fa, fb in zip(a, b):
        for k in ("color", "depth", "mask", "cam_in_ob"):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trail_reads_in_both_packages(tmp_path, writer):
    """A trail written by either package reads back equal in both."""
    tracker, frames = _fake_frames()
    save = tart.save_newframe_result if writer == "port" else jart.save_newframe_result
    for f in frames:
        save(tracker, f, str(tmp_path), 2)
    t = tart.load_tracked_frames(str(tmp_path))
    j = jart.load_tracked_frames(str(tmp_path))
    _assert_frames_equal(t, j)
    assert tart.load_keyframes_yml(str(tmp_path))["00001"]["nerfed"]
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "ob_in_cam" / "00002.txt"),
                                  np.linalg.inv(frames[2].pose_in_model))
    # the depth is millimetre uint16, the mask 0/1, the color masked
    assert np.all(t[0]["color"][~frames[0].fg_mask] == 0)
    np.testing.assert_array_equal(t[1]["mask"], frames[1].fg_mask.astype(np.float32))


def test_trail_of_spdlog_1_has_no_images(tmp_path):
    tracker, frames = _fake_frames(n=2)
    for f in frames:
        tart.save_newframe_result(tracker, f, str(tmp_path), 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["keyframes.yml", "ob_in_cam"]
    assert tart.load_tracked_frames(str(tmp_path)) == []


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_config_yaml_round_trip(tmp_path, reader):
    """config_nerf.yml written by the port, read by either package: every
    value survives, floats like 1e-15 stay floats."""
    cfg = tconfig.default_nof_config().merged(
        {"sc_factor": 2.718281828459045, "translation": [1e-15, -0.25, 3.0],
         "fs_sdf": 1e-15, "lrate": 1e-3})
    path = str(tmp_path / "config_nerf.yml")
    cfg.save(path)
    load = tconfig.Cfg.load if reader == "port" else jconfig.Cfg.load
    back = load(path)
    assert back == cfg
    assert isinstance(back["fs_sdf"], float) and back["fs_sdf"] == 1e-15
    assert isinstance(back["translation"][0], float)


def test_jax_config_reads_in_port(tmp_path):
    cfg = jconfig.default_nof_config().merged({"sc_factor": 0.7 * 3.3, "fs_sdf": 1e-15})
    cfg.save(str(tmp_path / "c.yml"))
    assert tconfig.Cfg.load(str(tmp_path / "c.yml")) == cfg


def test_pipeline_writes_the_trail(tmp_path):
    """BundleSdf(save_artifacts=True) on the CPU: the tracking-only loop
    over 3 cube frames leaves a trail that the JAX package reads, with each
    keyframe's pose as tracked."""
    data = make_cube_sequence(n_frames=3, deg_per_frame=3.0)
    cfg = small_track_cfg()
    cfg["SPDLOG"] = 2
    pipe = BundleSdf(cfg_track=tconfig.Cfg.wrap(dict(cfg)), use_nof=False, device="cpu",
                     save_artifacts=True, out_dir=str(tmp_path / "out"))
    for k in range(3):
        pipe.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                 mask=data["masks"][k])
    out = str(tmp_path / "out")
    frames = jart.load_tracked_frames(out)
    _assert_frames_equal(tart.load_tracked_frames(out), frames)
    kf_ids = [f.id_str for f in pipe.bundler.keyframes]
    assert [f["id_str"] for f in frames] == kf_ids and len(kf_ids) >= 2
    for f, kf in zip(frames, pipe.bundler.keyframes):
        np.testing.assert_array_equal(f["cam_in_ob"], kf.pose_in_model)
    for k in range(3):
        np.testing.assert_allclose(np.loadtxt(f"{out}/ob_in_cam/{k:04d}.txt"),
                                   pipe.poses_log[f"{k:04d}"], rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="out_dir"):
        BundleSdf(use_nof=False, device="cpu", save_artifacts=True)
