"""The port's user-facing scripts (``bundlesdf_tpu_torch/scripts``) against
driving the pipeline directly and against the JAX package's scripts
(``scripts/run_custom.py``, ``run_ho3d.py``, ``benchmark_ho3d.py``):

  * ``run_custom --mode run_video --use_gui`` on 96 x 96 cube frames
    written as a YCBInEOAT folder, the config factories swapped for the
    small test configs: poses, mesh and dashboard PNGs equal to a
    ``BundleSdf`` fed the same frames directly (both draw from the same
    seeded generators);
  * its two YAMLs equal to those the JAX ``run_one_video`` writes for the
    same arguments (the JAX pipeline is not run);
  * ``draw_pose`` files equal to the JAX script's;
  * ``run_ho3d``'s skip-if-complete and ``--shard``;
  * ``benchmark_one_video`` and ``mesh_chamfer_vs_visible`` against the JAX
    script's on the same outputs: AUCs and mean errors within 1e-6, the
    chamfer within 1e-6 m (the ICP's float32 Kabsch SVD differs in its last
    bits between torch and XLA; 2.9e-8 m measured here), ``chamfer_distance``;
  * ``--log_compiles`` rejected, and CUDA as the default device."""
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from test_pipeline import small_nof_cfg, small_track_cfg
from bundlesdf_tpu.utils import metrics as jmetrics
from bundlesdf_tpu.utils.mesh import Mesh as JMesh
from bundlesdf_tpu_torch.config import Cfg, default_nof_config, default_track_config
from bundlesdf_tpu_torch.io.png import read_png
from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.scripts import benchmark_ho3d, run_custom, run_ho3d
from bundlesdf_tpu_torch.utils import metrics
from bundlesdf_tpu_torch.utils.mesh import Mesh, export_obj, load_obj

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
import benchmark_ho3d as jbench  # noqa: E402  (the JAX script)
import chip_smoke  # noqa: E402
import run_custom as jrun  # noqa: E402  (the JAX script)

torch.set_num_threads(2)

N_FRAMES = 6


def small_track():
    return Cfg.wrap(default_track_config().merged(small_track_cfg()))


def small_nof():
    return Cfg.wrap(default_nof_config().merged(small_nof_cfg()))


def _cube_video(n=N_FRAMES):
    data = make_cube_sequence(n_frames=n, deg_per_frame=3.0)
    return {"colors": [c.astype(np.uint8) for c in data["colors"]],
            "depths": data["depths"], "masks": data["masks"], "K": data["K"],
            "gt": list(data["gt_ob_in_cam"]), "half": data["half"]}


def _write_ycb(video, folder):
    """The YCBInEOAT layout with cv2 (as scripts/make_synth_video.py)."""
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for k, (c, d, m) in enumerate(zip(video["colors"], video["depths"], video["masks"])):
        name = f"{k:05d}.png"
        cv2.imwrite(os.path.join(folder, "rgb", name), c[..., ::-1])
        cv2.imwrite(os.path.join(folder, "depth", name), np.round(d * 1000).astype(np.uint16))
        cv2.imwrite(os.path.join(folder, "masks", name), (m > 0).astype(np.uint8) * 255)
    np.savetxt(os.path.join(folder, "cam_K.txt"), video["K"])


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """run_video through the script, and the same frames fed to BundleSdf."""
    video = _cube_video()
    root = tmp_path_factory.mktemp("cli")
    vdir = str(root / "video")
    _write_ycb(video, vdir)
    mp = pytest.MonkeyPatch()
    mp.setitem(run_custom.TRACK_CONFIGS, "custom", small_track)
    mp.setattr(run_custom, "default_nof_config", small_nof)
    try:
        pipe = run_custom.main(["--mode", "run_video", "--video_dir", vdir, "--out_folder",
                                f"{vdir}/out", "--debug_level", "2", "--use_gui",
                                "--shorter_side", "96", "--device", "cpu"])
    finally:
        mp.undo()

    cfg_track = small_track()
    cfg_track["SPDLOG"] = 2
    cfg_track["depth_processing"]["zfar"] = 1.0
    cfg_track["debug_dir"] = str(root / "direct")
    cfg_nof = small_nof()
    cfg_nof["ray_pool_reserve_log2"] = 20
    direct = BundleSdf(cfg_track=cfg_track, cfg_nof=cfg_nof, out_dir=str(root / "direct"),
                       save_artifacts=True, use_gui=True, device="cpu")
    K = np.loadtxt(os.path.join(vdir, "cam_K.txt"))
    for k in range(N_FRAMES):
        mask = (video["masks"][k] > 0).astype(np.uint8) * 255
        if k == 0:
            mask = cv2.erode(mask, np.ones((5, 5), np.uint8))
        depth = (np.round(video["depths"][k] * 1000).astype(np.uint16) / 1e3).astype(np.float32)
        direct.run(video["colors"][k], depth, K, f"{k:05d}", mask=mask)
    mesh = direct.on_finish()
    return {"video": video, "vdir": vdir, "out": f"{vdir}/out", "pipe": pipe,
            "direct": direct, "direct_mesh": mesh, "root": root}


def test_run_video_equals_driving_bundlesdf(cli_run):
    pipe, direct, out = cli_run["pipe"], cli_run["direct"], cli_run["out"]
    assert [f.id for f in pipe.bundler.keyframes] == [f.id for f in direct.bundler.keyframes]
    assert any(f.nerfed for f in pipe.bundler.keyframes)
    for k in range(N_FRAMES):
        pose = np.loadtxt(os.path.join(out, "ob_in_cam", f"{k:05d}.txt"))
        assert np.array_equal(pose, np.loadtxt(
            os.path.join(str(cli_run["root"] / "direct"), "ob_in_cam", f"{k:05d}.txt")))
        assert np.array_equal(pipe.poses_log[f"{k:05d}"], direct.poses_log[f"{k:05d}"])
        a = read_png(os.path.join(out, "dashboard", f"{k:05d}.png"))
        b = read_png(os.path.join(str(cli_run["root"] / "direct"), "dashboard", f"{k:05d}.png"))
        assert a.shape == (96, 288, 3) and np.array_equal(a, b), k
    mesh = load_obj(os.path.join(out, "mesh_online.obj"))
    assert len(mesh.vertices) > 50
    assert np.abs(mesh.vertices - cli_run["direct_mesh"].vertices).max() < 1e-6
    for name in ("config_track.yml", "config_nerf.yml", "keyframes.yml"):
        assert os.path.exists(os.path.join(out, name))


def test_draw_pose_equals_jax(cli_run, tmp_path):
    out = cli_run["out"]
    jout = str(tmp_path / "jax_out")
    shutil.copytree(os.path.join(out, "ob_in_cam"), os.path.join(jout, "ob_in_cam"))
    run_custom.main(["--mode", "draw_pose", "--video_dir", cli_run["vdir"],
                     "--out_folder", out])
    jrun.draw_pose(cli_run["vdir"], jout)
    names = sorted(os.listdir(os.path.join(out, "pose_vis")))
    assert names == sorted(os.listdir(os.path.join(jout, "pose_vis")))
    assert len(names) == N_FRAMES
    for n in names:
        a = read_png(os.path.join(out, "pose_vis", n))
        assert a.shape == (480, 480, 3)
        assert np.array_equal(a, read_png(os.path.join(jout, "pose_vis", n))), n


class _Stop(Exception):
    pass


def _stop(*args, **kw):
    raise _Stop


@pytest.mark.parametrize("dataset", ["custom", "ycbineoat"])
def test_config_yamls_equal_jax(tmp_path, monkeypatch, dataset):
    """Both scripts' run_one_video up to the reader (which is swapped for a
    stop): the YAMLs they wrote for the same arguments are equal."""
    vdir = tmp_path / "video"
    os.makedirs(vdir / "rgb")
    for k in range(7):
        (vdir / "rgb" / f"{k:05d}.png").touch()
    monkeypatch.setattr(run_custom, "YcbineoatReader", _stop)
    monkeypatch.setattr(jrun, "YcbineoatReader", _stop)
    with pytest.raises(_Stop):
        run_custom.run_one_video(str(vdir), str(tmp_path / "port"), debug_level=2,
                                 dataset=dataset, device="cpu")
    with pytest.raises(_Stop):
        jrun.run_one_video(str(vdir), str(tmp_path / "jax"), debug_level=2, dataset=dataset)
    for name in ("config_track.yml", "config_nerf.yml"):
        a = Cfg.load(str(tmp_path / "port" / name))
        b = Cfg.load(str(tmp_path / "jax" / name))
        for c, folder in ((a, "port"), (b, "jax")):  # where each was asked to write
            for key in ("debug_dir", "save_dir"):
                if key in c:
                    assert c[key] == str(tmp_path / folder)
                    c[key] = None
        assert a == b, name


def test_run_ho3d_skips_finished_videos_and_shards(tmp_path, monkeypatch):
    video = _cube_video(2)
    root = str(tmp_path / "HO3D_v3")
    for name in ("SM1", "SM2"):
        chip_smoke.write_ho3d_folder(video, range(2), root, name)
    monkeypatch.setattr(run_ho3d, "default_track_config", small_track)
    args = ["--ho3d_dir", root, "--out_dir", str(tmp_path / "out"), "--video_names",
            "SM1", "SM2", "--no_nerf", "--device", "cpu"]
    first = run_ho3d.main(args + ["--shard", "1/2"])
    assert list(first) == ["SM2"] and first["SM2"] is not None
    assert sorted(os.listdir(tmp_path / "out")) == ["SM2"]
    assert len(os.listdir(tmp_path / "out" / "SM2" / "ob_in_cam")) == 2
    assert run_ho3d.main(args + ["--shard", "1/2"]) == {"SM2": None}
    both = run_ho3d.main(args)
    assert both["SM1"] is not None and both["SM2"] is None
    assert os.path.exists(tmp_path / "out" / "SM1" / "config_nerf.yml")
    assert run_ho3d.main(args[:4] + ["--video_names", "AP10", "--device", "cpu"]) == {}


def _benchmark_case(tmp_path):
    """An HO3D folder of the cube and a run folder: noisy poses, a noisy
    cube mesh as mesh_online.obj."""
    video = _cube_video(4)
    root = str(tmp_path / "HO3D_v3")
    vdir = chip_smoke.write_ho3d_folder(video, range(4), root)
    out = tmp_path / "out" / "SM1"
    os.makedirs(out / "ob_in_cam")
    rng = np.random.default_rng(0)
    for k, T in enumerate(video["gt"]):
        P = T.copy()
        P[:3, 3] += rng.normal(scale=0.004, size=3)
        np.savetxt(out / "ob_in_cam" / f"{k:04d}.txt", P)
    shell = chip_smoke.cube_shell(0.15, 12)
    export_obj(Mesh(shell.vertices + rng.normal(scale=0.002, size=shell.vertices.shape),
                    shell.faces), str(out / "mesh_online.obj"))
    return vdir, str(out), video


def test_benchmark_one_video_matches_jax(tmp_path):
    vdir, out, _ = _benchmark_case(tmp_path)
    port = benchmark_ho3d.benchmark_one_video(vdir, out, device="cpu")
    ref = jbench.benchmark_one_video(vdir, out)
    assert sorted(port) == sorted(ref) and "chamfer_cm" in port
    for key, v in ref.items():
        if isinstance(v, float):
            tol = 1e-4 if key == "chamfer_cm" else 1e-6  # 1e-6 m
            assert abs(port[key] - v) <= tol, (key, port[key], v)
        else:
            assert port[key] == v, key
    res = benchmark_ho3d.main(["--ho3d_dir", str(tmp_path / "HO3D_v3"), "--out_dir",
                               str(tmp_path / "out"), "--device", "cpu"])
    assert res["videos"][0] == port and os.path.exists(tmp_path / "out" / "benchmark.json")


def test_mesh_chamfer_vs_visible_matches_jax():
    rng = np.random.default_rng(1)
    shell = chip_smoke.cube_shell(0.1, 15)
    gt_pts = shell.sample_surface(3000, seed=3)
    v = shell.vertices + rng.normal(scale=0.003, size=shell.vertices.shape)
    pose0 = np.eye(4)
    pose0[:3, 3] = [0.01, -0.02, 0.5]
    gt0 = pose0.copy()
    gt0[:3, 3] += [0.004, 0.0, -0.003]
    a = benchmark_ho3d.mesh_chamfer_vs_visible(Mesh(v, shell.faces), gt_pts, pose0, gt0,
                                               device="cpu")
    b = jbench.mesh_chamfer_vs_visible(JMesh(v, shell.faces), gt_pts, pose0, gt0)
    assert abs(a - b) <= 1e-6 and 0 < a < 0.01


def test_chamfer_distance_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(500, 3)), rng.normal(size=(300, 3))
    assert metrics.chamfer_distance(a, b) == jmetrics.chamfer_distance(a, b)


def test_log_compiles_is_rejected_and_cuda_is_the_default(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        run_custom.parse_args(["--out_folder", "x", "--log_compiles"])
    assert e.value.code == 2 and "--log_compiles" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    vdir = str(tmp_path / "v")
    _write_ycb(_cube_video(1), vdir)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_custom.main(["--video_dir", vdir, "--out_folder", f"{vdir}/out"])
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_ho3d.icp_align(np.zeros((20, 3)), np.zeros((20, 3)))
