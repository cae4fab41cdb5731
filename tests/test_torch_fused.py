"""The fused device path of the port: the frame pool, the warp, the fused
corres program and the fused match + BA program, against the JAX package
on a 3-frame cube fixture, with the behaviours of tests/test_fused_corres.py.

The strict comparisons run the two JAX programs unfused (``unfused_jax``:
their bodies called eagerly, with the warp, matcher, RANSAC and BA each
still jitted).  A whole-program jit lets XLA fuse the warp's arithmetic
differently (about 1e-5 on [0, 255] gray), which moves Harris corners and
reorders matches, so only the behaviour is compared with the jitted
programs.  Match rows are ordered by ZNCC confidence, and confidences
within the f32 dot-product tolerance (1e-5) may swap rows, so tables are
compared keyed by their pixels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from bundlesdf_tpu.config import default_track_config as jax_track_cfg
from bundlesdf_tpu.ops import fused_corres as jfc
from bundlesdf_tpu.ops import fused_track as jft
from bundlesdf_tpu.tracking import corres as jcorres
from bundlesdf_tpu.tracking.device_pool import DeviceFramePool as JPool
from bundlesdf_tpu.tracking.frame import Frame as JFrame
from bundlesdf_tpu.tracking.pool import Bundler as JBundler
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.ops import fused_corres as tfc
from bundlesdf_tpu_torch.tracking import corres as tcorres
from bundlesdf_tpu_torch.tracking.device_pool import DeviceFramePool as TPool
from bundlesdf_tpu_torch.tracking.frame import Frame as TFrame
from bundlesdf_tpu_torch.tracking.pool import Bundler as TBundler
from bundlesdf_tpu_torch.utils import profiler

torch.set_num_threads(2)
H = W = 96
# tests/test_pipeline.py::small_track_cfg, with fewer RANSAC trials
SMALL = {"feature_corres": {"resize": 160, "max_matches_per_pair": 256},
         "ransac": {"max_iter": 256}, "bundle": {"max_BA_frames": 5},
         "depth_processing": {"percentile": 100}}


def jax_draws(seed, shape):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


@pytest.fixture
def unfused_jax(monkeypatch):
    monkeypatch.setattr(jfc, "fused_find_corres_packed",
                        jfc.fused_find_corres_packed.__wrapped__)
    monkeypatch.setattr(jft, "fused_match_ba", jft.fused_match_ba.__wrapped__)


def _keyed(m, fields=("valid", "inlier", "pA", "pB")):
    """Rows of a match table with a valid pixel pair, keyed by it."""
    rows = {}
    for r in np.nonzero(np.any(m["uvA"] != 0, axis=-1) | m["valid"])[0]:
        key = tuple(m["uvA"][r]) + tuple(m["uvB"][r])
        rows[key] = tuple(np.asarray(m[f][r]).tobytes() for f in fields)
    return rows


def _cfgs():
    return jax_track_cfg().merged(SMALL), default_track_config().merged(SMALL)


@pytest.fixture(scope="module")
def frames():
    """3 frames of the 96 x 96 cube sequence, 4 deg apart, at their true
    poses (cam -> object frame)."""
    cfg_j, cfg_t = _cfgs()
    data = make_cube_sequence(n_frames=3, H=H, W=W, deg_per_frame=4.0)
    fj, ft = [], []
    for k in range(3):
        for cls, cfg, out in ((JFrame, cfg_j, fj), (TFrame, cfg_t, ft)):
            f = cls(data["colors"][k], data["depths"][k], data["K"], id=k,
                    id_str=f"{k:05d}", cfg=cfg, fg_mask=data["masks"][k] > 0)
            f.pose_in_model = np.linalg.inv(data["gt_ob_in_cam"][k]).astype(np.float32)
            out.append(f)
    return cfg_j, cfg_t, fj, ft


def test_pool_decode_bitwise(frames):
    _, _, fj, ft = frames
    pj = JPool(H, W, capacity=4)
    pt = TPool(capacity=4, device="cpu")
    assert pj.ensure(fj) == pt.ensure(ft)
    np.testing.assert_array_equal(pt.gray.numpy(), np.asarray(pj.gray))
    np.testing.assert_array_equal(pt.depth.numpy(), np.asarray(pj.depth))
    np.testing.assert_array_equal(pt.normals.numpy(), np.asarray(pj.normals))
    f = ft[0]
    assert np.abs(pt.depth[0].numpy() - f.depth).max() <= 1e-4 + 1e-6  # 0.1 mm
    assert np.abs(pt.normals[0].numpy() - f.normals).max() <= 1.5 / 127.0


def test_pool_lru_eviction(frames):
    _, _, _, ft = frames
    pool = TPool(capacity=2, device="cpu")
    s0 = pool.ensure([ft[0]])[0]
    assert pool.ensure([ft[0]]) == [s0]  # resident: no re-upload
    pool.ensure([ft[1]])
    pool.ensure([ft[2]])  # evicts frame 0 (least recently used)
    assert ft[0].id not in pool.slot_of and ft[2].id in pool.slot_of
    with pytest.raises(RuntimeError):
        TPool(capacity=1, device="cpu").ensure(ft[:2])


def test_pool_slot_is_made_again_after_a_version_bump():
    """A change to a resident frame's maps bumps its version, and the next
    ``ensure`` decodes it again into the same slot: the planes hold the
    new maps, not the stale ones; an unchanged frame is not uploaded."""
    _, cfg_t = _cfgs()
    data = make_cube_sequence(n_frames=2, H=H, W=W, deg_per_frame=4.0)
    ft = [TFrame(data["colors"][k], data["depths"][k], data["K"], id=k, id_str=str(k),
                 cfg=cfg_t, fg_mask=data["masks"][k] > 0) for k in range(2)]
    pool = TPool(capacity=2, device="cpu")
    profiler.reset()
    slots = pool.ensure(ft)
    keep = np.ones((H, W), bool)
    keep[:, : W // 2] = False
    ft[0].invalidate_pixels_by_mask(keep)
    assert pool.depth[slots[0]].numpy()[:, : W // 2].any()
    assert pool.ensure(ft) == slots
    assert profiler.stats()["launch/pool_upload"]["count"] == 3
    fresh = TPool(capacity=1, device="cpu")
    fresh.ensure(ft[:1])
    for a in ("gray", "depth", "normals"):
        np.testing.assert_array_equal(getattr(pool, a)[slots[0]].numpy(),
                                      getattr(fresh, a)[0].numpy())
    assert not pool.depth[slots[0]].numpy()[:, : W // 2].any()


def test_warp_crop_matches_jax(frames):
    cfg_j, _, fj, ft = frames
    S = 160
    tfA, tfB = jcorres.pair_homographies(fj[1], fj[0], S)
    t2A, t2B = tcorres.pair_homographies(ft[1], ft[0], S)
    np.testing.assert_array_equal(tfA, t2A)
    np.testing.assert_array_equal(tfB, t2B)
    gray = np.round(fj[0].gray).astype(np.float32)
    inv = np.stack([np.linalg.inv(tfA), np.linalg.inv(tfB)]).astype(np.float32)
    warp = jax.jit(lambda g, t: jfc._warp_crop(g, t, S))
    ref = np.stack([np.asarray(warp(jnp.asarray(gray), jnp.asarray(t))) for t in inv])
    out = tfc._warp_crop(torch.from_numpy(gray).expand(2, H, W), torch.from_numpy(inv), S)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)
    assert ref.max() > 50


def _store_pair(frames_t, cfg, draws_seed, pairs_idx):
    store = tcorres.CorresStore(cfg, device="cpu")
    tcorres.find_corres(store, [(frames_t[a], frames_t[b]) for a, b in pairs_idx], cfg,
                        key=draws_seed, ransac_draws=jax_draws)
    return store


@pytest.mark.parametrize("pairs_idx", [[(1, 0)], [(1, 0), (2, 0), (2, 1)]])
def test_fused_find_corres_matches_jax(frames, pairs_idx, unfused_jax):
    """Single pair (P=1) and 3 pairs (padded to pair_batch/2 = 8): match
    tables equal to the unfused JAX program's, inlier rows equal except
    within 1e-6 m^2 of the 5 mm gate, Procrustes offsets within 1e-4."""
    cfg_j, cfg_t, fj, ft = frames
    store_j = jcorres.CorresStore(cfg_j)
    jcorres.find_corres(store_j, [(fj[a], fj[b]) for a, b in pairs_idx], cfg_j,
                        key=jax.random.PRNGKey(4))
    store_t = _store_pair(ft, cfg_t, 4, pairs_idx)
    for a, b in pairs_idx:
        mj, mt = store_j.matches[(a, b)], store_t.matches[(a, b)]
        kj, kt = _keyed(mj, ("valid", "pA", "pB", "nA", "nB")), _keyed(
            mt, ("valid", "pA", "pB", "nA", "nB"))
        assert kt == kj
        assert mt["valid"].sum() == mj["valid"].sum() > 20
        raw_t, raw_j = store_t.raw[(a, b)], store_j.raw[(a, b)]
        np.testing.assert_array_equal(raw_t[np.lexsort(raw_t.T)], raw_j[np.lexsort(raw_j.T)])
        assert mt["inlier"].sum() >= 10, (a, b)
        off_j = jcorres.procrustes_offset(store_j, fj[a], fj[b])
        off_t = tcorres.procrustes_offset(store_t, ft[a], ft[b])
        np.testing.assert_allclose(off_t, off_j, rtol=0, atol=1e-4)
        Ta, Tb = ft[a].pose_in_model, ft[b].pose_in_model
        d2 = (((mt["pA"] @ Ta[:3, :3].T + Ta[:3, 3]) - (mt["pB"] @ Tb[:3, :3].T + Tb[:3, 3]))
              ** 2).sum(-1)
        near = {tuple(mt["uvA"][r]) + tuple(mt["uvB"][r])
                for r in np.nonzero(np.abs(d2 - 0.005 ** 2) <= 1e-6)[0]}
        inl_t, inl_j = _keyed(mt, ("inlier",)), _keyed(mj, ("inlier",))
        assert {k: v for k, v in inl_t.items() if k not in near} == \
            {k: v for k, v in inl_j.items() if k not in near}


def test_fused_find_corres_behaves_like_jitted_jax(frames):
    """Against the jitted JAX program: similar inlier counts, near-equal
    Procrustes offsets (the bounds of tests/test_fused_corres.py)."""
    cfg_j, cfg_t, fj, ft = frames
    store_j = jcorres.CorresStore(cfg_j)
    jcorres.find_corres(store_j, [(fj[1], fj[0])], cfg_j, key=jax.random.PRNGKey(1))
    store_t = _store_pair(ft, cfg_t, 1, [(1, 0)])
    nj = int(store_j.matches[(1, 0)]["inlier"].sum())
    nt = int(store_t.matches[(1, 0)]["inlier"].sum())
    assert nt >= 0.7 * nj and nj >= 0.7 * nt and nt >= 20
    off_j = jcorres.procrustes_offset(store_j, fj[1], fj[0])
    off_t = tcorres.procrustes_offset(store_t, ft[1], ft[0])
    assert np.abs(off_t[:3, 3] - off_j[:3, 3]).max() < 1e-3
    assert np.abs(off_t[:3, :3] - off_j[:3, :3]).max() < 5e-3


def test_raw_reuse_pairs_raise(frames, unfused_jax):
    """Raw-match reuse no longer raises: a pair matched by the fused
    program, then invalidated (NOF feedback), is re-gated from its raw
    table under a moved pose through the host path, with no matcher or
    fused launch and one RANSAC, as the JAX package does it."""
    from bundlesdf_tpu_torch.utils import profiler as tprof

    cfg_j, cfg_t, fj, ft = frames
    store_j = jcorres.CorresStore(cfg_j)
    jcorres.find_corres(store_j, [(fj[1], fj[0])], cfg_j, key=jax.random.PRNGKey(3))
    store_t = _store_pair(ft, cfg_t, 3, [(1, 0)])
    moved = []
    for store, f in ((store_j, fj[1]), (store_t, ft[1])):
        store.invalidate_matches(1)
        assert (1, 0) in store.raw and (1, 0) not in store.matches
        moved.append((f, f.pose_in_model))
        f.pose_in_model = f.pose_in_model.copy()
        f.pose_in_model[:3, 3] += np.float32(0.002)
    try:
        tprof.reset()
        jcorres.find_corres(store_j, [(fj[1], fj[0])], cfg_j, key=jax.random.PRNGKey(6))
        tcorres.find_corres(store_t, [(ft[1], ft[0])], cfg_t, key=6, ransac_draws=jax_draws)
        counts = {k: v["count"] for k, v in tprof.stats().items()}
        assert counts["launch/ransac"] == 1
        assert not {"launch/corres", "launch/fused_match_ba"} & set(counts)
        mj, mt = store_j.matches[(1, 0)], store_t.matches[(1, 0)]
        assert _keyed(mt, ("valid", "pA", "pB")) == _keyed(mj, ("valid", "pA", "pB"))
        assert mt["inlier"].sum() == mj["inlier"].sum() >= 10
    finally:
        for f, pose in moved:
            f.pose_in_model = pose


def test_fused_match_ba_matches_jax(frames, unfused_jax):
    """Bundler.match_and_optimize (the fused match + BA program) on 3
    frames with perturbed poses: (1, 0) matched earlier (host edges), (2, 0)
    and (2, 1) fresh.  Poses within 1e-4 of the unfused JAX program's; the
    fresh tables equal; frame 0 fixed."""
    cfg_j, cfg_t, fj, ft = frames
    out = {}
    for name, B, fr in (("jax", JBundler, fj), ("torch", TBundler, ft)):
        b = B(cfg_j) if name == "jax" else B(cfg_t, device="cpu")
        fr = [_clone(f) for f in fr]
        rng = np.random.default_rng(0)
        for f in fr[1:]:
            f.pose_in_model = f.pose_in_model.copy()
            f.pose_in_model[:3, 3] += rng.normal(0, 0.002, 3).astype(np.float32)
        b.firstframe, b.newframe = fr[0], fr[2]
        b.keyframes = [fr[0], fr[1]]
        b.frames = {0: fr[0], 1: fr[1], 2: fr[2]}
        if name == "jax":
            jcorres.find_corres(b.store, [(fr[1], fr[0])], cfg_j,
                                key=jax.random.PRNGKey(1))
            done = b.match_and_optimize([(fr[2], fr[0]), (fr[2], fr[1])], fr,
                                        jax.random.PRNGKey(2))
        else:
            tcorres.find_corres(b.store, [(fr[1], fr[0])], cfg_t, key=1,
                                ransac_draws=jax_draws)
            done = b.match_and_optimize([(fr[2], fr[0]), (fr[2], fr[1])], fr, 2,
                                        jax_draws)
        assert done and fr[2].status == 0
        out[name] = ([f.pose_in_model.copy() for f in fr], b.store)
    (pj, sj), (pt, st) = out["jax"], out["torch"]
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pt[0], ft[0].pose_in_model)
    for key in ((2, 0), (2, 1)):
        assert _keyed(st.matches[key], ("valid",)) == _keyed(sj.matches[key], ("valid",))
        assert st.matches[key]["inlier"].sum() >= 10


def _clone(f):
    import copy

    return copy.copy(f)
