"""The port's LoFTR (``bundlesdf_tpu_torch/models/loftr.py``) against the
benchmark's plain reference (``portbench/reference/loftr.py``, the
upstream's equations in plain torch) on seeded weights, and the FLOP count
(``portbench/loftr_costs.py``) against ``torch.utils.flop_counter``.

Both run at the narrow config of tests/test_torch_loftr.py (blocks
16/24/32, d_coarse 32, d_fine 16, 4 heads) on 64 x 64 images, with one
state dict that ``make_weights`` draws and the port loads.  Both compute
in float32, summing in other orders (the reference's ``F.conv2d`` and
``F.unfold`` windows against the port's convolutions and gathers): the
gaps they leave measure 3e-6 to 9e-6 on the confidence matrix and under
5e-5 px on the fine coordinates, where the reference in TF32 leaves 1e-3
to 1e-2 and 1e-2 to 1e-1 px."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bundlesdf_tpu_torch.io import imgproc
from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.tracking.corres import _rotate_image_transform
from portbench import loftr_costs
from portbench.reference import loftr as rl

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4)
# 10x above the float32 reordering gaps (module docstring), 10x below TF32's
CONF_RTOL = 1e-4
FINE_ATOL_PX = 1e-3


def widths(**over) -> dict:
    return dict(rl.CVPR_DS, **NARROW, **over)


def port(w: dict, sd: dict, K: int) -> lt.LoftrModule:
    cfg = lt.LoftrCfg(**{k: w[k] for k in rl.CVPR_DS}, max_matches=K)
    return lt.load_weights(lt.LoftrModule(cfg), sd).eval()


def images(seed: int, n: int = 3, same=()):
    g = torch.Generator().manual_seed(seed)
    a, b = torch.rand(n, 1, 64, 64, generator=g), torch.rand(n, 1, 64, 64, generator=g)
    for i in same:
        b[i] = a[i]
    return a, b


def inner(ids: torch.Tensor, Wc: int) -> torch.Tensor:
    """Cells whose 5 x 5 fine window lies inside the 1/2 map (row and column
    above 0): there the port's clamped windows equal the upstream's
    zero-padded ones."""
    return (ids // Wc > 0) & (ids % Wc > 0)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.loftr, portbench.loftr_costs; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, env=dict(os.environ, PYTHONPATH=REPO)).stdout.split()
    for name in ("bundlesdf_tpu_torch", "bundlesdf_tpu", "jax", "jaxlib", "flax"):
        assert name not in out


@pytest.mark.parametrize("w", [rl.CVPR_DS, widths()], ids=["published", "narrow"])
def test_weights_carry_the_port_state_dict_names(w):
    sd = rl.make_weights(7, w)
    module = lt.LoftrModule(lt.LoftrCfg(**{k: w[k] for k in rl.CVPR_DS}))
    names = {k: tuple(v.shape) for k, v in module.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert names == {k: tuple(v.shape) for k, v in sd.items()}
    assert torch.equal(rl.make_weights(7, w)["loftr_coarse.layers.3.q_proj.weight"],
                       sd["loftr_coarse.layers.3.q_proj.weight"])


def test_confidence_matrix_matches_reference():
    w = widths()
    sd = rl.make_weights(3, w)
    a, b = images(0)
    with torch.no_grad():
        out = port(w, sd, 48)(a, b)
        ref = rl.forward(sd, a, b, w, block=2)
    gap = ((out["conf_matrix"] - ref["conf"]).flatten(1).norm(dim=1)
           / ref["conf"].flatten(1).norm(dim=1))
    assert gap.max() <= CONF_RTOL, gap


def _ref_matches(conf, w, p):
    b, i, j, mconf = rl.coarse_matches(conf[p:p + 1], 8, 8, w["thr"], w["border_rm"])
    order = torch.argsort(mconf, descending=True, stable=True)
    return i[order], j[order], mconf[order]


def test_coarse_ids_match_where_the_top_k_cut_is_separated():
    """thr 0 and K 3 on pairs of one image twice (many mutual matches):
    where the reference's K-th and (K+1)-th scores differ by more than the
    confidence tolerance, the port's valid top K are the reference's."""
    K = 3
    w = widths(thr=0.0)
    sd = rl.make_weights(4, w)
    a, b = images(1, n=3, same=(0, 1, 2))
    b[1] = torch.roll(a[1], shifts=(8, 8), dims=(1, 2))
    with torch.no_grad():
        out = port(w, sd, K)(a, b)
        conf = rl.forward(sd, a, b, w, block=3)["conf"]
    cut = 0
    for p in range(a.shape[0]):
        i, j, s = _ref_matches(conf, w, p)
        got = {(int(x), int(y)) for x, y, v in zip(out["i_ids"][p], out["j_ids"][p],
                                                   out["valid"][p]) if v}
        if len(s) > K:
            if s[K - 1] - s[K] <= CONF_RTOL * s[0]:
                continue
            cut += 1
        assert got == {(int(x), int(y)) for x, y in zip(i[:K], j[:K])}, p
    assert cut >= 1


def test_threshold_selects_the_reference_matches():
    """The published threshold 0.2 with one image on both sides: the port's
    valid matches are the upstream's, ids and confidences."""
    w = widths()
    sd = rl.make_weights(6, w)
    a, b = images(2, n=2, same=(0, 1))
    with torch.no_grad():
        out = port(w, sd, 48)(a, b)
        ref = rl.forward(sd, a, b, w, block=1)
    assert ref["counts"].min() >= 3
    assert torch.equal(out["valid"].sum(1), ref["counts"])
    for p in range(2):
        i, j, s = _ref_matches(ref["conf"], w, p)
        v = out["valid"][p]
        got = sorted(zip(out["i_ids"][p][v].tolist(), out["j_ids"][p][v].tolist(),
                         out["conf"][p][v].tolist()))
        want = sorted(zip(i.tolist(), j.tolist(), s.tolist()))
        assert [g[:2] for g in got] == [x[:2] for x in want]
        np.testing.assert_allclose([g[2] for g in got], [x[2] for x in want],
                                   rtol=CONF_RTOL)


def test_fine_coordinates_at_given_ids_match_reference():
    """Teacher-forced at random coarse ids (the port's ``gt_ids`` path, the
    upstream's training path): equal where both windows lie inside the
    fine map; at the map's border the port clamps, the upstream pads with
    zeros."""
    w = widths()
    sd = rl.make_weights(6, w)
    a, b = images(3)
    g = torch.Generator().manual_seed(9)
    ids = (torch.randint(0, 64, (3, 20), generator=g), torch.randint(0, 64, (3, 20), generator=g))
    with torch.no_grad():
        out = port(w, sd, 20)(a, b, gt_ids=ids)
        ref = rl.forward(sd, a, b, w, ids=ids, block=3)
    keep = inner(ids[0], 8) & inner(ids[1], 8)
    assert keep.sum() >= 20
    dev = (out["mkpts1_f"] - ref["mkpts1_f"]).abs().amax(-1)
    assert dev[keep].max() <= FINE_ATOL_PX
    torch.testing.assert_close(out["conf_matrix"], ref["conf"], rtol=0,
                               atol=CONF_RTOL * float(ref["conf"].max()))


def test_tf32_control_is_outside_the_tolerances():
    """The control (TF32 operands) moves the confidence matrix by more than
    its tolerance: the tolerances tell a precision apart."""
    w = widths()
    sd = rl.make_weights(3, w)
    a, b = images(0)
    with torch.no_grad():
        ref = rl.forward(sd, a, b, w)
        ctl = rl.forward(sd, a, b, w, precision="tf32")
    gap = (ctl["conf"] - ref["conf"]).flatten(1).norm(dim=1) / ref["conf"].flatten(1).norm(dim=1)
    assert gap.max() > 10 * CONF_RTOL


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest_even():
    one = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 3 * 2.0 ** -11), 3.0e-3])
    r = rl.tf32_round(one)
    assert r[:3].tolist() == [1.0, 1 + 2.0 ** -9, -(1 + 2.0 ** -9)]
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rx = rl.tf32_round(x)
    assert ((rx.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((rx - x).abs() <= x.abs() * 2.0 ** -11).all()


def test_reference_restores_the_precision_switches():
    w = widths()
    sd = rl.make_weights(3, w)
    a, b = images(0, n=1)
    b_ = torch.backends
    old = (b_.cuda.matmul.allow_tf32, b_.cudnn.allow_tf32)
    try:
        b_.cuda.matmul.allow_tf32, b_.cudnn.allow_tf32 = True, False
        for precision in ("ref", "tf32"):
            rl.forward(sd, a, b, w, precision=precision)
            assert (b_.cuda.matmul.allow_tf32, b_.cudnn.allow_tf32) == (True, False)
        with pytest.raises(ValueError):
            rl.forward(sd, a, b, w, precision="bf16")
        assert (b_.cuda.matmul.allow_tf32, b_.cudnn.allow_tf32) == (True, False)
    finally:
        b_.cuda.matmul.allow_tf32, b_.cudnn.allow_tf32 = old


def test_plain_warp_moves_pixels_as_the_homography_says():
    """An integer shift reads the image's own pixels; a crop beyond the
    image reads 0."""
    img = torch.rand(12, 16, generator=torch.Generator().manual_seed(0)) * 255
    shift = np.array([[1.0, 0, -2], [0, 1, -3], [0, 0, 1]])
    assert torch.equal(rl.warp(img, shift, 8), img[3:11, 2:10].double())
    away = np.array([[1.0, 0, 40], [0, 1, 0], [0, 0, 1]])
    assert not rl.warp(img, away, 8).any()


def test_plain_warp_matches_the_program_warp():
    """The program's OpenCV float arithmetic (f32 coordinates) against the
    plain float64 warp at a rotated, scaled crop of a noise image: 9e-4 of
    a grey level measured, so 1e-2 holds it 10x; the control's TF32
    coordinates move it by grey levels."""
    img = torch.rand(48, 64, generator=torch.Generator().manual_seed(0)) * 255
    M = (np.diag([1.3, 1.3, 1.0]) @ np.array([[1, 0, -5.5], [0, 1, -3.25], [0, 0, 1]])
         @ _rotate_image_transform(48, 64, 0.4))
    plain = rl.warp(img, M, 64)
    gap = (imgproc.warp_perspective(img, M, (64, 64)).double() - plain).abs().max()
    assert gap <= 1e-2
    assert (rl.warp(img, M, 64, "tf32") - plain).abs().max() > 1.0
    with pytest.raises(ValueError):
        rl.warp(img, M, 64, "bf16")


@pytest.mark.parametrize("hw,B,K", [((64, 64), 2, 48), ((64, 96), 1, 20)])
def test_flop_count_matches_flop_counter(hw, B, K):
    """The port's forward at fixed capacity K, and the reference's (its fine
    stage at K given ids; its expectation is a sum, not a product)."""
    w = widths()
    sd = rl.make_weights(3, w)
    a = torch.rand(B, 1, *hw)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        port(w, sd, K)(a, a)
    want = B * loftr_costs.pair_flops(w, *hw, K)
    assert fc.get_total_flops() == want
    ids = (torch.zeros(B, K, dtype=torch.long), torch.zeros(B, K, dtype=torch.long))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        rl.forward(sd, a, a, w, ids=ids, block=B)
    assert fc.get_total_flops() == want - B * 2 * K * w["window"] ** 2 * 2


def test_published_flops_per_pair():
    """385.3 GFLOP a 400 x 400 pair at K 512: 2 x 154.7 in the backbones."""
    assert loftr_costs.backbone_flops(rl.CVPR_DS, 400, 400) == 154_695_360_000
    assert loftr_costs.pair_flops(rl.CVPR_DS, 400, 400, 512) == 385_308_632_064
