"""Import boundaries and defaults of the PyTorch port (bundlesdf_tpu_torch).

The port imports torch and never jax, and nothing of the JAX package
bundlesdf_tpu (whose name is a prefix of the port's: checks test
``name == "bundlesdf_tpu"`` or ``name.startswith("bundlesdf_tpu.")``).  It
never imports OpenCV or pyzmq either: the machine with the card has none.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bundlesdf_tpu import config as jax_config
from bundlesdf_tpu_torch import config as port_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "bundlesdf_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` and ``cv2`` blocked, and
    no ``bundlesdf_tpu`` module gets loaded (a subprocess: conftest imports
    jax into this one)."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
sys.modules["sklearn"] = None
sys.modules["PIL"] = None
sys.modules["imageio"] = None
sys.modules["zmq"] = None
import bundlesdf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bundlesdf_tpu_torch.__path__,
                                                "bundlesdf_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import kernel_ab
bad = [n for n in sys.modules
       if n == "bundlesdf_tpu" or n.startswith("bundlesdf_tpu.")]
assert not bad, bad
assert all(sys.modules[m] is None for m in ("jax", "cv2", "sklearn", "PIL", "imageio", "zmq"))
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 40  # every subpackage and module
    for mod in ("io.scene_bounds", "utils.mesh", "nof.runner", "pipeline.bundlesdf",
                "io.png", "pipeline.artifacts", "ops.raster", "nof.texture",
                "io.readers", "io.segmentation", "io.imgproc", "io.jpeg", "viz.draw",
                "viz.renderer", "viz.gui", "viz.glyphs", "scripts.run_custom",
                "scripts.run_ho3d", "scripts.benchmark_ho3d", "models.loftr",
                "models.loftr_train", "ops.sift", "io.zmtp", "io.remote_matcher",
                "parallel.distributed", "parallel.mesh", "parallel.nof_shard",
                "parallel.ba_shard", "parallel.joint", "scripts.synth_hard",
                "scripts.eval_matcher", "scripts.benchmark_synth",
                "scripts.benchmark_long"):
        assert f"bundlesdf_tpu_torch.{mod}" in names


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    for mod in _IMPORT.findall(path.read_text()):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "optax", "flax", "cv2", "sklearn", "PIL",
                            "imageio", "zmq"), (
            path, mod)
        assert mod != "bundlesdf_tpu" and not mod.startswith("bundlesdf_tpu."), (
            path, mod)


def test_entry_defaults_to_cuda():
    """Entry points take device=None as CUDA and raise without a card."""
    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.models import nof as nof_model
    from bundlesdf_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.build_nof()
    with pytest.raises(RuntimeError, match="CUDA"):
        nof_model.params_from_jax({"table": [0.0]})
    assert resolve_device("cpu") == torch.device("cpu")


def test_tracker_entry_points_default_to_cuda():
    """The tracker's constructors take device=None as CUDA and raise without
    a card; nothing falls back to the CPU."""
    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.tracking.corres import CorresStore
    from bundlesdf_tpu_torch.tracking.device_pool import DeviceFramePool
    from bundlesdf_tpu_torch.tracking.pool import Bundler

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from bundlesdf_tpu_torch.models.loftr import LoftrMatcher
    from bundlesdf_tpu_torch.tracking.corres import make_matcher

    from bundlesdf_tpu_torch.models.matcher import SiftMatcher

    cfg = default_track_config()
    loftr = default_track_config().merged({"feature_corres": {"matcher": "loftr"}})
    sift = default_track_config().merged({"feature_corres": {"matcher": "sift"}})
    for make in (entry.build_tracker, lambda: BundleSdf(use_nof=False),
                 lambda: Bundler(cfg), lambda: CorresStore(cfg),
                 lambda: DeviceFramePool(2), LoftrMatcher,
                 lambda: make_matcher(loftr), lambda: entry.build_tracker(loftr),
                 SiftMatcher, lambda: make_matcher(sift), lambda: CorresStore(sift)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_pipeline_entry_points_default_to_cuda():
    """The joint loop's constructors take device=None as CUDA and raise
    without a card; so does the NOF runner."""
    import numpy as np

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config
    from bundlesdf_tpu_torch.nof.runner import NofRunner
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    z = np.zeros((1, 8, 8), np.float32)
    for make in (entry.build_pipeline, BundleSdf, lambda: BundleSdf(use_nof=True),
                 lambda: NofRunner(default_nof_config(), np.zeros((1, 8, 8, 3), np.float32),
                                   z, z, np.eye(4, dtype=np.float32)[None],
                                   np.eye(3, dtype=np.float32), np.zeros((4, 3)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("kind", ["rematch_after_nerf", "save_artifacts", "use_gui"])
def test_unported_pipeline_options_raise_at_construction(kind, tmp_path):
    """Options that were not ported raised when the pipeline was built, not
    mid-video.  All three are ported now: ``save_artifacts`` and
    ``use_gui`` build and ask for the out_dir they write to (the dashboard's
    PNGs go to ``out_dir/dashboard``); ``rematch_after_nerf`` builds."""
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf

    if kind in ("save_artifacts", "use_gui"):
        with pytest.raises(ValueError, match="out_dir"):
            BundleSdf(**{kind: True})
        pipe = BundleSdf(**{kind: True}, out_dir=str(tmp_path / "o"), device="cpu")
        assert (tmp_path / "o").is_dir()
        if kind == "use_gui":
            assert pipe.gui is not None and (tmp_path / "o" / "dashboard").is_dir()
        else:
            assert pipe.save_artifacts and pipe.gui is None
        return
    # rematch_after_nerf is ported: it builds, and asks for the card like
    # any other pipeline
    cfg = default_track_config()
    cfg["feature_corres"]["rematch_after_nerf"] = True
    assert BundleSdf(cfg_track=cfg, device="cpu").cfg_track is cfg
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BundleSdf(cfg_track=cfg)


@pytest.mark.parametrize("engine", ["sift", "remote"])
def test_unported_matcher_engines_raise(engine):
    """Every matcher engine is ported now (the name is kept from when
    ``sift`` and ``remote`` raised NotImplementedError): ``sift`` builds the
    device SIFT engine on the CPU when asked, ``remote`` a client of
    ``feature_corres.remote_port`` with no server up (it connects at its
    first match).  ``loftr`` builds, and an unknown engine is a
    ValueError."""
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.io.remote_matcher import RemoteMatcher
    from bundlesdf_tpu_torch.models.loftr import LoftrMatcher
    from bundlesdf_tpu_torch.models.matcher import SiftMatcher
    from bundlesdf_tpu_torch.tracking.corres import make_matcher

    cfg = default_track_config().merged({"feature_corres": {"matcher": engine}})
    m = make_matcher(cfg, "cpu")
    if engine == "sift":
        assert isinstance(m, SiftMatcher) and m.max_matches == 512
        assert m.device == torch.device("cpu") and m.compiled is False
    else:
        assert isinstance(m, RemoteMatcher) and m.compiled is False
        assert m._sock.port == 5555 and m._sock._conn is None
    m = make_matcher(cfg.merged({"feature_corres": {"matcher": "loftr"}}), "cpu")
    assert isinstance(m, LoftrMatcher) and m.cfg.max_matches == 512
    with pytest.raises(ValueError, match="unknown"):
        make_matcher(cfg.merged({"feature_corres": {"matcher": "orb"}}), "cpu")


def test_default_nof_config_equals_jax():
    port = port_config.default_nof_config()
    ref = jax_config.default_nof_config()
    assert list(port) == list(ref)
    assert port == ref
    merged = port.merged({"hash_scatter": "pallas"})
    assert merged.hash_scatter == "pallas" and port.hash_scatter == "auto"
