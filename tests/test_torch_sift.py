"""The port's device SIFT (``bundlesdf_tpu_torch/ops/sift.py``) against
OpenCV's ``SIFT_create(nfeatures=2000).detectAndCompute``, which the JAX
package's ``SiftMatcher`` calls, and the port's ``SiftMatcher`` against
the JAX one, on the CPU.

Keypoints are compared as sets (cv2 does not specify their order once
``retainBest`` trims): a port keypoint matches a cv2 one when ``pt`` is
within 0.01 px, ``size`` within 1e-3 relative, ``angle`` within 0.1 deg
modulo 360, and the octave is the same.  Measured on these inputs
(recall, precision, share of equal descriptors among matched keypoints):

  * blob image of tests/test_matcher.py:72-77: 1.0, 1.0, 1.0 (147
    keypoints);
  * a 160 x 160 warped frame of the cube sequence: 1.0, 1.0, 1.0 (255
    keypoints), also when retainBest trims it to 100;
  * a flat image: no keypoints in either.

The bounds are 0.95, 0.95 and 0.90.  The scale space equals cv2's bit for
bit (the upsampling is exact, the blur follows OpenCV's summation order
and fused multiply-adds, ``fast_atan2`` equals ``cv2.phase``); what can
still differ is a descriptor element within ~1e-4 of a rounding edge, by
1 (OpenCV's exp and magnitude round differently by an ulp, and its
histograms sum in another order): on the cube crop resized to 400 x 400 1
descriptor of 220 has such an element, on a 400 x 400 blurred-noise image
with 2000 keypoints 2.  An earlier blur that summed the taps in another
order, within 4 ulps of cv2's, lost 4 of the blob's 147 orientations:
the piecewise-flat image has near-tied histogram bins."""
import cv2
import numpy as np
import pytest
import torch

from synthetic_cube import make_cube_sequence
from bundlesdf_tpu.models.matcher import SiftMatcher as JSiftMatcher
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.models.matcher import SiftMatcher
from bundlesdf_tpu_torch.ops import sift
from bundlesdf_tpu_torch.tracking import corres as tcorres
from bundlesdf_tpu_torch.tracking.frame import Frame

torch.set_num_threads(2)

PT_TOL, SIZE_RTOL, ANGLE_TOL = 0.01, 1e-3, 0.1
RECALL_MIN = PRECISION_MIN = 0.95
DESC_EQUAL_MIN = 0.90


def blob_image():
    """The blob image of tests/test_matcher.py:72-77."""
    rng = np.random.default_rng(0)
    img = np.zeros((120, 120), np.uint8)
    for _ in range(40):
        y, x = rng.integers(10, 110, 2)
        img[max(0, y - 3):y + 3, max(0, x - 3):x + 3] = rng.integers(80, 255)
    return cv2.GaussianBlur(img, (5, 5), 1.0)


@pytest.fixture(scope="module")
def cube_pair():
    """Frames 2 and 0 of the 96 x 96 cube sequence warped to 160 x 160 by
    the port's ``process_image_pair``, truncated to uint8 as the matchers
    convert them."""
    cfg = default_track_config().merged({"depth_processing": {"percentile": 100}})
    data = make_cube_sequence(n_frames=3, H=96, W=96, deg_per_frame=4.0)
    fr = []
    for k in (2, 0):
        f = Frame(data["colors"][k], data["depths"][k], data["K"], id=k, id_str=str(k),
                  cfg=cfg, fg_mask=data["masks"][k] > 0)
        f.pose_in_model = np.linalg.inv(data["gt_ob_in_cam"][k]).astype(np.float32)
        fr.append(f)
    a, b, _, _ = tcorres.process_image_pair(fr[0], fr[1], 160, device="cpu")
    return a.numpy().astype(np.uint8), b.numpy().astype(np.uint8)


def _port_keypoints(img, nfeatures=2000):
    r = sift.detect_and_compute(torch.from_numpy(img)[None], nfeatures)
    n = int(r["count"][0])
    return {k: r[k][0, :n].numpy() for k in ("pt", "size", "angle", "octave", "desc")}


def _cv2_keypoints(img, nfeatures=2000):
    kps, des = cv2.SIFT_create(nfeatures=nfeatures).detectAndCompute(img, None)
    return {"pt": np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            "size": np.array([k.size for k in kps], np.float32),
            "angle": np.array([k.angle for k in kps], np.float32),
            "octave": np.array([k.octave for k in kps], np.int64),
            "desc": des if des is not None else np.zeros((0, 128), np.float32)}


def match_keypoint_sets(ref, got):
    """Greedy one-to-one matching of keypoint sets under the tolerances.
    Returns (recall, precision, share of matched pairs with equal
    descriptors, largest descriptor element difference)."""
    used = np.zeros(len(got["pt"]), bool)
    pairs = []
    for i in range(len(ref["pt"])):
        ok = ((np.abs(got["pt"] - ref["pt"][i]).max(axis=1) <= PT_TOL)
              & (np.abs(got["size"] - ref["size"][i]) <= SIZE_RTOL * ref["size"][i])
              & (np.abs((got["angle"] - ref["angle"][i] + 180) % 360 - 180) <= ANGLE_TOL)
              & ((got["octave"] & 255) == (ref["octave"][i] & 255)) & ~used)
        hit = np.nonzero(ok)[0]
        if len(hit):
            used[hit[0]] = True
            pairs.append((i, hit[0]))
    n_ref, n_got = len(ref["pt"]), len(got["pt"])
    recall = len(pairs) / n_ref if n_ref else 1.0
    precision = len(pairs) / n_got if n_got else 1.0
    eq = [np.array_equal(ref["desc"][i], got["desc"][j]) for i, j in pairs]
    diff = max((np.abs(ref["desc"][i] - got["desc"][j]).max() for i, j in pairs), default=0)
    return recall, precision, float(np.mean(eq)) if eq else 1.0, float(diff)


def test_fast_atan2_equals_cv2_phase():
    """OpenCV's vectorised fastAtan2 (what SIFT calls, exposed as
    ``cv2.phase``), bit for bit, in all four quadrants and on the axes."""
    rng = np.random.default_rng(1)
    x = rng.integers(-255, 256, 50000).astype(np.float32) + rng.random(50000).astype(np.float32)
    y = rng.integers(-255, 256, 50000).astype(np.float32)
    x[:500] = 0
    y[500:1000] = 0
    ref = cv2.phase(x, y, angleInDegrees=True).ravel()
    out = sift.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("sigma,shape", [(1.2490000, (74, 106)), (1.2262735, (40, 36)),
                                         (3.0900364, (74, 106)), (3.0900364, (5, 4))],
                         ids=["base", "layer1", "layer5", "tiny"])
def test_gaussian_blur_equals_cv2(sigma, shape):
    """``cv2.GaussianBlur(f32, (0, 0), sigma)`` bit for bit: the same taps,
    reflect-101 borders (also where the kernel is wider than the image),
    OpenCV's summation order and fused multiply-adds, and the scalar code
    of the columns past the last vector of 8 (widths 106 and 36 have such
    columns).  Widths where a final 4-column vector meets a scalar tail
    of 3 can differ in an element (1 of 270 width, height and sigma cases
    measured: width 7)."""
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.float32)
    ref = cv2.GaussianBlur(img, (0, 0), sigma, sigma)
    out = sift.gaussian_blur(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_array_equal(out, ref)


def test_base_upsample_equals_cv2_resize():
    """The 2x base before its blur is ``cv2.resize`` INTER_LINEAR, bit for
    bit; the number of octaves is OpenCV's for the base's size."""
    img = np.random.default_rng(3).integers(0, 256, (37, 53)).astype(np.uint8)
    ref = cv2.resize(img.astype(np.float32), (106, 74), interpolation=cv2.INTER_LINEAR)
    up = torch.nn.functional.interpolate(torch.from_numpy(img).float()[None, None],
                                         scale_factor=2, mode="bilinear", align_corners=False)
    np.testing.assert_array_equal(up[0, 0].numpy(), ref)
    assert sift.n_octaves(400, 400) == 9 and sift.n_octaves(120, 120) == 7


@pytest.mark.parametrize("case", ["blob", "cube", "flat", "cube_retain_best"])
def test_detect_and_compute_matches_cv2(case, cube_pair):
    """Keypoint sets and descriptors against cv2's detectAndCompute.
    ``cube_retain_best`` asks for 100 features, so that retainBest trims
    (ties at the bar are kept, as cv2 keeps them)."""
    nfeatures = 100 if case == "cube_retain_best" else 2000
    img = {"blob": blob_image(), "cube": cube_pair[0], "cube_retain_best": cube_pair[0],
           "flat": np.zeros((160, 160), np.uint8)}[case]
    ref = _cv2_keypoints(img, nfeatures)
    got = _port_keypoints(img, nfeatures)
    recall, precision, desc_eq, diff = match_keypoint_sets(ref, got)
    if case == "flat":
        assert len(ref["pt"]) == len(got["pt"]) == 0
        return
    assert len(ref["pt"]) >= 100
    assert recall >= RECALL_MIN and precision >= PRECISION_MIN, (recall, precision)
    assert desc_eq >= DESC_EQUAL_MIN and diff <= 1, (desc_eq, diff)
    assert np.all(got["desc"] == np.round(got["desc"])) and got["desc"].max() <= 255
    if case == "cube_retain_best":
        assert len(got["pt"]) >= nfeatures


def _rows_match(ref, got):
    """Share of ``ref`` rows with a ``got`` row within PT_TOL on all four
    pixel columns (one-to-one)."""
    used = np.zeros(len(got), bool)
    hit = 0
    for r in ref:
        ok = (np.abs(got[:, :4] - r[:4]).max(axis=1) <= PT_TOL) & ~used
        i = np.nonzero(ok)[0]
        if len(i):
            used[i[0]] = True
            hit += 1
    return hit / max(len(ref), 1)


def test_sift_matcher_matches_jax(cube_pair):
    """``SiftMatcher.predict`` against the JAX engine on a batch of three
    pairs: identity, a shift, and the cube pair.  Rows match as sets within
    0.01 px both ways, and the valid counts are within 5%.  Measured: the
    same rows in the same order on all three (148, 145 and 118 rows),
    equal to 5e-10 (the cube pair's confidences)."""
    img = blob_image()
    shifted = np.roll(img, (7, 4), axis=(0, 1))
    a = np.zeros((3, 160, 160), np.uint8)
    b = np.zeros((3, 160, 160), np.uint8)
    a[0, :120, :120], b[0, :120, :120] = img, img
    a[1, :120, :120], b[1, :120, :120] = img, shifted
    a[2], b[2] = cube_pair
    cj, vj = JSiftMatcher(max_matches=512).predict(a, b)
    ct, vt = SiftMatcher(max_matches=512, device="cpu").predict(a, b)
    assert ct.shape == cj.shape and ct.dtype == np.float32 and vt.dtype == bool
    for i in range(3):
        rj, rt = cj[i][vj[i]], ct[i][vt[i]]
        assert len(rj) >= 10
        assert abs(len(rt) - len(rj)) <= 0.05 * len(rj), (i, len(rt), len(rj))
        assert _rows_match(rj, rt) >= 0.95 and _rows_match(rt, rj) >= 0.95, i
        # sorted by confidence, the invalid tail zeroed
        assert np.all(np.diff(rt[:, 4]) <= 0) and not ct[i][~vt[i]].any()


def test_sift_matcher_identity_and_shift():
    """tests/test_matcher.py:65-96 on the port: identical images match at
    zero displacement; a pure translation is recovered."""
    img = blob_image()
    m = SiftMatcher(max_matches=128, device="cpu")
    corres, valid = m.predict(img[None], img[None])
    assert valid[0].sum() >= 10
    c = corres[0][valid[0]]
    np.testing.assert_allclose(c[:, :2], c[:, 2:4], atol=0.5)
    shifted = np.roll(img, (7, 4), axis=(0, 1))
    corres, valid = m.predict(img[None], shifted[None])
    c = corres[0][valid[0]]
    assert len(c) >= 10
    med = np.median(c[:, 2:4] - c[:, :2], axis=0)
    np.testing.assert_allclose(med, [4.0, 7.0], atol=0.7)


@pytest.mark.parametrize("scale", [1.0, 255.0], ids=["unit", "byte"])
def test_sift_matcher_uint8_conversion_equals_jax(scale):
    """f32 input in [0, 1] is divided by A's maximum and scaled by 255, f32
    in [0, 255] is kept; both are truncated to uint8, as the JAX engine's
    numpy does (``bundlesdf_tpu/models/matcher.py:222-226``)."""
    rng = np.random.default_rng(4)
    a = (rng.random((2, 40, 40)) * scale * 0.9).astype(np.float32)
    b = (rng.random((2, 40, 40)) * scale).astype(np.float32)
    mx = max(float(a.max()), 1e-6)
    ra = (a / mx * 255 if mx <= 1.5 else a).astype(np.uint8)
    rb = (b / mx * 255 if mx <= 1.5 else b).astype(np.uint8)
    ta, tb = SiftMatcher(device="cpu")._to_uint8(a, b)
    np.testing.assert_array_equal(ta.numpy(), ra)
    np.testing.assert_array_equal(tb.numpy(), rb)
    ta, tb = SiftMatcher(device="cpu")._to_uint8(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), ra)


def test_sift_matcher_few_keypoints_gives_invalid_rows():
    """Fewer than 2 keypoints on a side: an all-invalid, all-zero row, as
    the JAX engine returns; the other pair of the batch still matches."""
    img = blob_image()
    a = np.stack([np.zeros_like(img), img])
    cj, vj = JSiftMatcher(max_matches=64).predict(a, a)
    ct, vt = SiftMatcher(max_matches=64, device="cpu").predict(a, a)
    assert not vj[0].any() and not vt[0].any() and not ct[0].any()
    assert vt[1].sum() == vj[1].sum() >= 10
    assert SiftMatcher.compiled is False
