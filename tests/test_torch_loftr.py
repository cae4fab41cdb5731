"""The port's LoFTR (``bundlesdf_tpu_torch/models/loftr.py``) and the pair
warp of the host-warp path (``io/imgproc.py::warp_perspective``) against the
JAX package and OpenCV.

LoFTR runs at a narrow config (blocks 16/24/32, d_coarse 32, d_fine 16, 4
heads) on 64 x 64 images.  One random state dict in the reference torch
layout (the port's seeded init) goes to JAX through
``loftr_jax.convert_torch_state_dict`` and to the port through
``load_state_dict``; the JAX side runs jitted.  The tracker through LoFTR
runs both packages with that engine injected as ``store.matcher`` on the
cube sequence of tests/test_torch_tracker.py."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from test_pipeline import small_track_cfg
from bundlesdf_tpu.models import loftr_jax as lj
from bundlesdf_tpu.pipeline.bundlesdf import BundleSdf as JBundleSdf
from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.config import Cfg, default_track_config
from bundlesdf_tpu_torch.io.imgproc import warp_perspective
from bundlesdf_tpu_torch.models import loftr as lt

torch.set_num_threads(2)

NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4,
              thr=0.0, max_matches=48)
CFG_T, CFG_J = lt.LoftrCfg(**NARROW), lj.LoftrCfg(**NARROW)


def _rel_close(out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max(), np.abs(out - ref).max()


def _homographies(rng, n):
    Ms = []
    for _ in range(n):
        a = rng.uniform(-0.8, 0.8)
        M = np.eye(3)
        M[:2, :2] = rng.uniform(0.6, 2.5) * np.array([[np.cos(a), -np.sin(a)],
                                                      [np.sin(a), np.cos(a)]])
        M[:2, 2] = rng.uniform(-40, 40, 2)
        M[2, :2] = rng.uniform(-1.5e-3, 1.5e-3, 2)
        Ms.append(M)
    return Ms


@pytest.mark.parametrize("size", [160, 400])
def test_warp_perspective_matches_cv2(size):
    """Random homographies over a [0, 255] noise image: within 1e-3 grey
    levels of cv2.warpPerspective, and the zero border on the same pixels."""
    rng = np.random.default_rng(size)
    img = rng.uniform(0, 255, (120, 150)).astype(np.float32)
    for M in _homographies(rng, 6):
        ref = cv2.warpPerspective(img, M, (size, size))
        out = warp_perspective(torch.from_numpy(img), M, (size, size)).numpy()
        assert out.dtype == np.float32 and out.shape == (size, size)
        assert np.abs(out - ref).max() <= 1e-3
        np.testing.assert_array_equal(out == 0, ref == 0)
        assert 0 < (ref == 0).mean() < 0.95


@pytest.fixture(scope="module")
def weights():
    """A seeded random state dict in the reference layout, the JAX params
    converted from it, and the port's module loaded with it."""
    module = lt.init_weights(lt.LoftrModule(CFG_T), seed=0)
    sd = {k: v.numpy().copy() for k, v in module.state_dict().items()}
    params = lj.convert_torch_state_dict(sd, CFG_J)
    port = lt.load_weights(lt.LoftrModule(CFG_T), sd).eval()
    return sd, params, port


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    a = rng.random((2, 64, 64)).astype(np.float32)
    # B is A shifted by 3 px with a small ramp, so the matches are not all
    # on the diagonal of the conf matrix
    b = np.roll(a, 3, axis=2) * 0.9 + 0.05 * np.linspace(0, 1, 64, dtype=np.float32)
    return a, b


@pytest.fixture(scope="module")
def jax_out(weights, images):
    _, params, _ = weights
    a, b = images
    fn = jax.jit(lambda p, x, y: lj.LoftrModule(CFG_J).apply(p, x, y))
    out = fn(params, jnp.asarray(a[..., None]), jnp.asarray(b[..., None]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port_out(weights, images):
    _, _, port = weights
    a, b = images
    with torch.no_grad():
        out = port(torch.from_numpy(a[:, None]), torch.from_numpy(b[:, None]))
    return {k: v.numpy() for k, v in out.items()}


def test_backbone_matches_jax(weights, images):
    _, params, port = weights
    x = images[0]
    jc, jf = lj.ResNetFPN82(CFG_J).apply(
        {"params": params["params"]["backbone"],
         "batch_stats": params["batch_stats"]["backbone"]}, jnp.asarray(x[..., None]))
    with torch.no_grad():
        tc, tf = port.backbone(torch.from_numpy(x[:, None]))
    _rel_close(tc.permute(0, 2, 3, 1).numpy(), jc, 1e-4)
    _rel_close(tf.permute(0, 2, 3, 1).numpy(), jf, 1e-4)
    assert tc.shape == (2, 32, 8, 8) and tf.shape == (2, 16, 32, 32)


@pytest.mark.parametrize("bug_fix", [True, False])
def test_pos_encoding_matches_jax(bug_fix):
    out = lt.sine_pos_encoding(8, 10, 32, temp_bug_fix=bug_fix)
    ref = lj.sine_pos_encoding(8, 10, 32, temp_bug_fix=bug_fix)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_encoder_layer_matches_jax(weights):
    _, params, port = weights
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 32)).astype(np.float32)
    s = rng.normal(size=(2, 50, 32)).astype(np.float32)
    ref = lj.LoftrEncoderLayer(32, 4).apply(
        {"params": params["params"]["loftr_coarse"]["layer3"]}, jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        out = port.loftr_coarse.layers[3](torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_matching_pieces_match_jax():
    """dual_softmax_conf, fine_expectation and linear_attention on random
    inputs."""
    rng = np.random.default_rng(2)
    f0 = rng.normal(size=(2, 30, 16)).astype(np.float32)
    f1 = rng.normal(size=(2, 30, 16)).astype(np.float32)
    np.testing.assert_allclose(
        lt.dual_softmax_conf(torch.from_numpy(f0), torch.from_numpy(f1), 0.1).numpy(),
        np.asarray(lj.dual_softmax_conf(jnp.asarray(f0), jnp.asarray(f1), 0.1)),
        rtol=0, atol=1e-6)
    w0 = rng.normal(size=(7, 25, 16)).astype(np.float32)
    w1 = rng.normal(size=(7, 25, 16)).astype(np.float32)
    np.testing.assert_allclose(
        lt.fine_expectation(torch.from_numpy(w0), torch.from_numpy(w1), 5).numpy(),
        np.asarray(lj.fine_expectation(jnp.asarray(w0), jnp.asarray(w1), 5)),
        rtol=0, atol=1e-6)
    q, k, v = (rng.normal(size=(2, n, 4, 8)).astype(np.float32) for n in (20, 24, 24))
    np.testing.assert_allclose(
        lt.linear_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(lj.linear_attention(*map(jnp.asarray, (q, k, v)))), rtol=0, atol=1e-5)


def test_conf_matrix_and_coarse_ids_match_jax(weights, images, port_out):
    """The coarse conf matrix within 1e-5 of the JAX one (its own backbone,
    encoding and coarse transformer on the same weights), and the coarse
    selection's (i, j) ids equal at thr 0 (the valid slots: every mutual
    nearest pair off the border; the rest in cell order).  The
    deviation is f32 rounding through the backbone and 8 layers, amplified
    by the 0.1 temperature: 5.2e-6 at weight seed 0, 3.0e-6 to 1.04e-5 over
    seeds 0-5 on these images."""
    _, params, _ = weights
    P, S = params["params"], params["batch_stats"]
    feats = []
    for x in images:
        fc, _ = lj.ResNetFPN82(CFG_J).apply(
            {"params": P["backbone"], "batch_stats": S["backbone"]}, jnp.asarray(x[..., None]))
        pe = lj.sine_pos_encoding(8, 8, 32, CFG_J.temp_bug_fix)
        feats.append((fc + pe[None]).reshape(2, 64, 32))
    f0, f1 = lj.LocalFeatureTransformer(32, 4, CFG_J.coarse_pairs, name="loftr_coarse").apply(
        {"params": P["loftr_coarse"]}, *feats)
    conf = lj.dual_softmax_conf(f0, f1, CFG_J.dsmax_temp)
    np.testing.assert_allclose(port_out["conf_matrix"], np.asarray(conf), rtol=0, atol=1e-5)
    i_ids, j_ids, mconf, valid = lj.coarse_match_fixed(conf, 8, 8, 0.0, 2, 48)
    np.testing.assert_array_equal(port_out["i_ids"], np.asarray(i_ids))
    np.testing.assert_array_equal(port_out["j_ids"], np.asarray(j_ids))
    np.testing.assert_array_equal(port_out["valid"], np.asarray(valid))
    assert port_out["valid"].sum() >= 4
    out = lt.coarse_match_fixed(torch.from_numpy(np.asarray(conf)), 8, 8, 0.0, 2, 48)
    for o, r in zip(out, (i_ids, j_ids, mconf, valid)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # K is clamped to the cell count
    assert lt.coarse_match_fixed(torch.from_numpy(np.asarray(conf)), 8, 8, 0.0, 2, 999)[0].shape \
        == (2, 64)


def test_full_model_matches_jax(jax_out, port_out):
    """mkpts0 equal, mkpts1 within 1e-3 px, conf within 1e-5, validity
    equal: the fine branch runs on the valid matches' real windows."""
    np.testing.assert_array_equal(port_out["valid"], jax_out["valid"])
    v = jax_out["valid"]
    np.testing.assert_array_equal(port_out["mkpts0"], jax_out["mkpts0"])
    np.testing.assert_allclose(port_out["mkpts1"][v], jax_out["mkpts1"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(port_out["conf"], jax_out["conf"], rtol=0, atol=1e-5)
    d = np.abs(jax_out["mkpts1"][v] - np.round(jax_out["mkpts1"][v] / 8) * 8)
    assert d.max() > 0.1  # the fine refinement moved the matches off the grid


def test_gt_ids_path_matches_jax(weights, images):
    """The teacher-forced training path: fine windows at given cells."""
    _, params, port = weights
    a, b = images
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 2, 10))
    fn = jax.jit(lambda p, x, y, i, j: lj.LoftrModule(CFG_J).apply(p, x, y, gt_ids=(i, j)))
    ref = fn(params, jnp.asarray(a[..., None]), jnp.asarray(b[..., None]),
             jnp.asarray(ids[0], jnp.int32), jnp.asarray(ids[1], jnp.int32))
    with torch.no_grad():
        out = port(torch.from_numpy(a[:, None]), torch.from_numpy(b[:, None]),
                   gt_ids=(torch.from_numpy(ids[0]), torch.from_numpy(ids[1])))
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["conf_matrix"].numpy(), np.asarray(ref["conf_matrix"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["mkpts0"].numpy(), np.asarray(ref["mkpts0"]))
    np.testing.assert_allclose(out["mkpts1_f"].numpy(), np.asarray(ref["mkpts1_f"]),
                               rtol=0, atol=1e-3)


def test_state_dict_round_trip(weights):
    """state_dict_from_flax inverts convert_torch_state_dict: every weight
    comes back equal (BatchNorm's num_batches_tracked is not carried)."""
    sd, params, _ = weights
    back = lt.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), CFG_T)
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_checkpoints_load_with_outputs_equal_to_jax(weights, images, jax_out, tmp_path):
    """An .npz written by the JAX package's save_params_npz, and a torch
    .ckpt with the released checkpoints' ``matcher.`` prefix, load into the
    port's LoftrMatcher; predict equals the JAX module's matches.  A missing
    weight raises."""
    sd, params, _ = weights
    a, b = images
    npz = str(tmp_path / "loftr.npz")
    lj.save_params_npz(params, npz)
    ckpt = str(tmp_path / "loftr.ckpt")
    torch.save({"state_dict": {f"matcher.{k}": torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 3}, ckpt)
    ref = np.concatenate([jax_out["mkpts0"], jax_out["mkpts1"], jax_out["conf"][..., None]], -1)
    v = jax_out["valid"]
    for path in (npz, ckpt):
        m = lt.load_checkpoint(path, CFG_T, device="cpu")
        corres, valid = m.predict(a * 255.0, b * 255.0)  # [0, 255]: divided by 255
        np.testing.assert_array_equal(valid, v)
        np.testing.assert_allclose(corres[v], ref[v], rtol=0, atol=1e-3)
    broken = dict(sd)
    del broken["loftr_fine.layers.1.merge.weight"]
    with pytest.raises(KeyError, match="merge"):
        lt.load_weights(lt.LoftrModule(CFG_T), broken)
    # only num_batches_tracked may be absent
    lt.load_weights(lt.LoftrModule(CFG_T), {k: v for k, v in sd.items()
                                            if not k.endswith("num_batches_tracked")})


def test_matcher_contract_and_seeded_init():
    """(B, K, 5) + (B, K) numpy from (B, H, W) inputs cropped to multiples
    of 8; the seed fixes the weights; a call counts one launch."""
    m = lt.LoftrMatcher(CFG_T, seed=5, device="cpu")
    m2 = lt.LoftrMatcher(CFG_T, seed=5, device="cpu")
    for k, v in m.module.state_dict().items():
        assert torch.equal(v, m2.module.state_dict()[k]), k
    rng = np.random.default_rng(6)
    a = rng.random((3, 70, 75)).astype(np.float32)
    before = lt.launches
    corres, valid = m.predict(a, a)
    assert lt.launches == before + 1
    assert corres.shape == (3, 48, 5) and valid.shape == (3, 48) and valid.dtype == bool
    assert corres[..., 0].max() < 72 and corres[..., 1].max() < 64
    # the same image on both sides: matches stay within a coarse cell
    c = corres[valid]
    assert len(c) > 0 and np.median(np.abs(c[:, 0:2] - c[:, 2:4]).max(-1)) <= 8.0


def _run(tracker, data, n):
    frames = [tracker.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                          mask=data["masks"][k]) for k in range(n)]
    return (np.stack([tracker.poses_log[f"{k:04d}"] for k in range(n)]),
            [f.status for f in frames], [f.id for f in tracker.bundler.keyframes])


def test_tracker_through_loftr_matches_jax(weights, tmp_path):
    """The tracker with the narrow LoFTR as its engine in both packages
    (the same weights; the JAX key's RANSAC draws): the host-warp path
    for every pair, poses within 1 mm and 0.2 deg, the same keyframes and
    statuses, and a LoFTR launch at each fresh match."""
    from bundlesdf_tpu_torch.utils import profiler as tprof

    sd, params, _ = weights
    n = 4
    data = make_cube_sequence(n_frames=n, deg_per_frame=3.0)
    cfg = small_track_cfg()
    cfg["feature_corres"]["pair_batch"] = 4
    jpipe = JBundleSdf(cfg_track=cfg, use_nof=False, out_dir=str(tmp_path))
    jpipe.bundler.store.matcher = lj.LoftrMatcher(CFG_J, params=params)

    def jax_draws(seed, shape):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape)))

    tracker = entry.build_tracker(Cfg.wrap(default_track_config().merged(cfg)), device="cpu",
                                  ransac_draws=jax_draws)
    tracker.bundler.store.matcher = lt.LoftrMatcher(CFG_T, state_dict=sd, device="cpu")
    assert not tracker.bundler.store.use_fused
    tprof.reset()
    before = lt.launches
    p_t, st_t, kf_t = _run(tracker, data, n)
    counts = {k: v["count"] for k, v in tprof.stats().items()}
    p_j, st_j, kf_j = _run(jpipe, data, n)
    assert kf_t == kf_j and st_t == st_j == [0] * n
    assert lt.launches - before == counts["launch/corres"] >= n - 1
    assert counts["launch/ba"] >= 1 and "launch/fused_match_ba" not in counts
    for a, b in zip(p_t.astype(np.float64), p_j.astype(np.float64)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3
        chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / 2 ** 1.5
        assert np.degrees(2 * np.arcsin(min(1.0, chord))) < 0.2
