"""Corner matcher of the port (bundlesdf_tpu_torch.models.matcher) against the
JAX package's models/matcher.py: Harris response, top-corner order (with
ties), and the match tables."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.models import matcher as jm
from bundlesdf_tpu_torch.models import matcher as tm

torch.set_num_threads(2)


def textured(H=96, W=112, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H // 8 + 2, W // 8 + 2))
    img = np.kron(img, np.ones((8, 8)))[:H, :W]
    img += 0.05 * rng.normal(size=(H, W))
    return img.astype(np.float32)


def test_harris_response_matches_jax():
    img = textured()
    out = tm.harris_response(torch.from_numpy(img)).numpy()
    ref = np.asarray(jm.harris_response(jnp.asarray(img)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    batched = tm.harris_response(torch.from_numpy(np.stack([img, img[::-1].copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), out)


def test_top_corners_match_jax_without_near_ties():
    cfg_j = jm.CornerMatcherCfg(max_corners=64)
    cfg_t = tm.CornerMatcherCfg(max_corners=64)
    resp = np.array(jm.harris_response(jnp.asarray(textured(seed=1))))
    # the fixture has no near-ties among the selected corners: the sorted
    # top scores are separated by more than the 1e-5 response tolerance
    top = np.sort(resp[resp > 0])[::-1][:80]
    assert np.min(-np.diff(top)) > 1e-5 * np.abs(resp).max()
    uv_j, s_j, v_j = jm._top_corners(jnp.asarray(resp), cfg_j)
    uv_t, s_t, v_t = tm._top_corners(torch.from_numpy(resp)[None], cfg_t)
    np.testing.assert_array_equal(uv_t[0].numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(s_t[0].numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_j))
    assert v_t.sum() > 20


def test_top_corners_tie_order_matches_jax():
    """Exact ties (equal peaks, and the -inf of every non-corner) keep the
    lower flat index first, as jax.lax.top_k does."""
    resp = np.zeros((40, 40), np.float32)
    for k, (v, u) in enumerate([(12, 12), (12, 25), (25, 12), (25, 25), (18, 30)]):
        resp[v, u] = 2.0 if k < 4 else 1.0
    cfg_j = jm.CornerMatcherCfg(max_corners=16, patch=4)
    cfg_t = tm.CornerMatcherCfg(max_corners=16, patch=4)
    uv_j, s_j, v_j = jm._top_corners(jnp.asarray(resp), cfg_j)
    uv_t, s_t, v_t = tm._top_corners(torch.from_numpy(resp)[None], cfg_t)
    np.testing.assert_array_equal(uv_t[0].numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_j))
    assert v_t[0].sum() == 5
    np.testing.assert_array_equal(uv_t[0, :4].numpy(), [[12, 12], [25, 12], [12, 25], [25, 25]])


@pytest.mark.parametrize("shift", [(0, 0), (3, -5)])
def test_match_pair_tables_match_jax(shift):
    a = textured(seed=2)
    b = np.roll(a, shift, axis=(0, 1)) * 0.9 + 0.02
    cfg_j = jm.CornerMatcherCfg(max_matches=128)
    cfg_t = tm.CornerMatcherCfg(max_matches=128)
    rj = jm.match_pair(jnp.asarray(a), jnp.asarray(b), cfg_j)
    rt = tm.match_pair(torch.from_numpy(a), torch.from_numpy(b), cfg_t)
    vj = np.asarray(rj["valid"])
    np.testing.assert_array_equal(rt["valid"].numpy(), vj)
    assert vj.sum() > 20
    cj, ct = np.asarray(rj["corres"]), rt["corres"].numpy()
    # rows are ordered by confidence, and ZNCC confidences near 1 may tie
    # within the 1e-5 f32 dot-product tolerance: compare the valid rows as
    # a table keyed by their pixels
    oj = np.lexsort(cj[vj, :4].T[::-1])
    ot = np.lexsort(ct[vj, :4].T[::-1])
    np.testing.assert_array_equal(ct[vj][ot, :4], cj[vj][oj, :4])
    np.testing.assert_allclose(ct[vj][ot, 4], cj[vj][oj, 4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct[vj, 4], cj[vj, 4], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ct[~vj], 0.0)
    # the matches found the shift
    du = ct[vj, 2] - ct[vj, 0]
    dv = ct[vj, 3] - ct[vj, 1]
    assert np.mean((du == shift[1]) & (dv == shift[0])) > 0.9


def test_match_pairs_batched_equals_single():
    a = np.stack([textured(seed=s) for s in (3, 4)])
    b = np.stack([np.roll(x, (2, 1), axis=(0, 1)) for x in a])
    cfg = tm.CornerMatcherCfg(max_matches=64)
    res = tm.match_pairs_batched(torch.from_numpy(a), torch.from_numpy(b), cfg)
    for i in range(2):
        one = tm.match_pair(torch.from_numpy(a[i]), torch.from_numpy(b[i]), cfg)
        np.testing.assert_array_equal(res["corres"][i].numpy(), one["corres"].numpy())
        np.testing.assert_array_equal(res["valid"][i].numpy(), one["valid"].numpy())
