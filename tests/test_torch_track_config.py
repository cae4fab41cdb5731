"""The port's tracker configs against the JAX package's: the same keys, in
the same order, with the same values."""
import pytest

from bundlesdf_tpu import config as jax_config
from bundlesdf_tpu_torch import config as port_config

NAMES = ["default_track_config", "ycbineoat_track_config", "behave_track_config"]


def _keys(d, prefix=""):
    out = []
    for k, v in d.items():
        out.append(prefix + k)
        if isinstance(v, dict):
            out += _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("name", NAMES)
def test_track_config_equals_jax(name):
    port = getattr(port_config, name)()
    ref = getattr(jax_config, name)()
    assert _keys(port) == _keys(ref)
    assert port == ref
    assert isinstance(port, port_config.Cfg)
    assert isinstance(port["feature_corres"], port_config.Cfg)


def test_track_config_defaults_take_the_fused_corner_path():
    cfg = port_config.default_track_config()
    assert cfg.feature_corres.matcher == "corner"
    assert cfg.bundle.fused_ba is True
    assert (cfg.feature_corres.resize, cfg.feature_corres.max_matches_per_pair,
            cfg.ransac.max_iter, cfg.bundle.max_BA_frames,
            cfg.bundle.fused_ba_pairs, cfg.depth_processing.percentile) == (
                400, 512, 2000, 10, 12, 95)
    # a variant is a fresh copy: editing it leaves the defaults alone
    ycb = port_config.ycbineoat_track_config()
    ycb["ransac"]["inlier_dist"] = 1.0
    assert port_config.ycbineoat_track_config()["ransac"]["inlier_dist"] == 0.015
