"""The port's LoFTR trainer (``bundlesdf_tpu_torch/models/loftr_train.py``)
against the benchmark's plain reference of the training step
(``portbench/reference/loftr_train.py``), the trainer's split of coarse
labels (``max_gt``) and fine cells (``fine_gt``), its entry, and the step's
FLOP count (``portbench/loftr_train_costs.py``) against
``torch.utils.flop_counter``.

Both sides run the narrow LoFTR of tests/test_torch_loftr.py on 64 x 64
homography pairs, from one state dict that ``make_weights`` draws and the
port loads, in float32, summing in other orders.  The gaps that leaves,
measured: losses 2e-7 to 6e-7 relative, gradients up to 8e-5 of a leaf's
norm (the BatchNorm variances, whose gradients cancel most), the change
after three steps up to 3e-3; the reference in TF32 moves them by 5e-4 to
1e-3, 0.25 and 0.23."""
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.models import loftr_train as tlt
from bundlesdf_tpu_torch.models.loftr import _without_cudnn
from bundlesdf_tpu_torch.utils import profiler
from portbench import loftr_costs, loftr_train_costs
from portbench.reference import loftr as rl
from portbench.reference import loftr_train as rt

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4)
W_ = dict(rl.CVPR_DS, **NARROW)
H = W = 64
GRID = (H // 8) * (W // 8)
TCFG = dict(H=H, W=W, batch=2, max_gt=GRID, lr=1e-2, warmup=2)
KEYS = ("img0", "img1", "i_ids", "j_ids", "pts1", "pos_mask")
# 10x above the float32 reordering gaps (module docstring); TF32's are
# 10x or more above each
LOSS_RTOL = 1e-5
CONF_RTOL = 1e-4
GRAD_RTOL = 1e-3
CHANGE_RTOL = 2e-2


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def port_module(sd) -> lt.LoftrModule:
    return lt.load_weights(lt.LoftrModule(lt.LoftrCfg(**W_)), sd).train()


def leaf_names(module) -> list:
    return ([n for n, _ in module.named_parameters()]
            + [n for n, _ in module.named_buffers() if n.endswith(("running_mean",
                                                                     "running_var"))])


def batches(n: int, max_gt: int = GRID, seed: int = 0, fine_gt=None) -> list:
    """``n`` (batch, fine draws) from one generator, in the step's order."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        b = tlt.make_batch(TCFG["batch"], H, W, max_gt, generator=g)
        u = None if fine_gt is None else torch.rand(tuple(b.i_ids.shape), generator=g)
        out.append((b, u))
    return out


def port_steps(sd, tcfg, data) -> dict:
    """The port's steps on ``data``: each step's loss and gradients before
    the clip, and each leaf's change."""
    module = port_module(sd)
    leaves = tlt.trainable(module)
    names = leaf_names(module)
    grads = []

    class Keep(tlt.LoftrOptimizer):
        def step(self):
            grads.append({n: p.grad.clone() for n, p in zip(names, self.leaves)})
            super().step()

    step = tlt.make_train_step(module, tcfg, Keep(leaves, tcfg, 10))
    losses = [float(step(b, fine_u=u)["loss"]) for b, u in data]
    change = {n: p.detach() - sd[n] for n, p in zip(names, leaves)}
    return {"losses": losses, "grads": grads, "change": change}


def ref_steps(sd, tcfg, data, precision="ref", block=1) -> dict:
    hyper = {"lr": tcfg.lr, "warmup": tcfg.warmup, "decay_steps": 10, "fine_gt": tcfg.fine_gt,
             "fine_weight": tcfg.fine_weight}
    return rt.train(sd, W_, [dict(zip(KEYS, b)) for b, _ in data], [u for _, u in data], hyper,
                    "cpu", precision, block)


def gaps(got, ref) -> dict:
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad": max(rel(g[k], r[k]) for g, r in zip(got["grads"], ref["grads"]) for k in r),
            "change": max(rel(got["change"][k], ref["change"][k]) for k in ref["change"])}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.loftr_train, portbench.loftr_train_costs; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, env=dict(os.environ, PYTHONPATH=REPO)).stdout.split()
    for name in ("bundlesdf_tpu_torch", "bundlesdf_tpu", "jax", "jaxlib", "flax"):
        assert name not in out


@pytest.mark.parametrize("fine_gt", [None, 12], ids=["fine_at_max_gt", "fine_gt_12"])
def test_three_steps_match_the_reference(fine_gt):
    """Losses, every leaf's gradient before the clip (the BatchNorm
    statistics too) and every leaf's change after three steps (lr 0, then
    the warmup's), pair by pair in the reference; the TF32 control falls
    outside the tolerances."""
    tcfg = tlt.TrainCfg(**TCFG, fine_gt=fine_gt)
    sd = rl.make_weights(11, W_)
    data = batches(3, fine_gt=fine_gt)
    got = port_steps(sd, tcfg, data)
    assert len(got["change"]) == len(sd) and set(got["change"]) == set(sd)
    g = gaps(got, ref_steps(sd, tcfg, data))
    assert g["loss"] <= LOSS_RTOL and g["grad"] <= GRAD_RTOL and g["change"] <= CHANGE_RTOL, g
    c = gaps(got, ref_steps(sd, tcfg, data, "tf32"))
    assert c["loss"] > 10 * LOSS_RTOL and c["grad"] > 10 * GRAD_RTOL, c


def test_pair_by_pair_equals_the_whole_batch():
    """Each pair's terms over the whole batch's counts, gradients summed:
    the whole batch's loss, gradients and confidence matrices to float32
    rounding (measured: 2e-5 of a leaf's norm, the BatchNorm variances'
    cancelling sums; 8e-6 of a matrix's, the CPU's convolutions differ by
    batch size)."""
    tcfg = tlt.TrainCfg(**TCFG, fine_gt=12)
    sd = rl.make_weights(12, W_)
    data = batches(2, fine_gt=12, seed=1)
    one = ref_steps(sd, tcfg, data, block=1)
    whole = ref_steps(sd, tcfg, data, block=2)
    for a, b in zip(one["losses"], whole["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    for ga, gb in zip(one["grads"], whole["grads"]):
        assert max(rel(ga[k], gb[k]) for k in gb) <= GRAD_RTOL / 10
    for pa, pb in zip(one["conf"], whole["conf"]):
        assert rel(pa, pb) <= CONF_RTOL


def _old_step(module, tcfg, optimizer):
    """The trainer's step as it was before ``fine_gt``: the forward at the
    batch's GT cells, the focal and fine losses over them."""

    def step(batch):
        optimizer.zero_grad()
        with _without_cudnn():
            out = module(batch.img0, batch.img1, gt_ids=(batch.i_ids, batch.j_ids))
        lc = tlt.coarse_focal_loss(out["conf_matrix"], batch.i_ids, batch.j_ids,
                                   batch.pos_mask, n_batch=tcfg.batch)
        lf = tlt.fine_l2_loss(out["mkpts1_f"], batch.pts1, batch.pos_mask)
        loss = lc + tcfg.fine_weight * lf
        with _without_cudnn():
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def test_fine_gt_none_is_the_old_step_bit_for_bit():
    tcfg = tlt.TrainCfg(**dict(TCFG, max_gt=24))
    sd = rl.make_weights(13, W_)
    data = batches(3, max_gt=24, seed=2)
    a, b = port_module(sd), port_module(sd)
    step_a = tlt.make_train_step(a, tcfg, tlt.LoftrOptimizer(tlt.trainable(a), tcfg, 10))
    step_b = _old_step(b, tcfg, tlt.LoftrOptimizer(tlt.trainable(b), tcfg, 10))
    for batch, _ in data:
        assert torch.equal(step_a(batch)["loss"], step_b(batch))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_max_gt_at_the_grid_labels_every_valid_cell():
    """At ``max_gt`` = the grid every valid cell is a positive and nothing
    is dropped; at 16 the first 16 valid cells are, and the counter holds
    the rest."""
    draws = tlt.draw_pair(3, H, W, torch.Generator().manual_seed(11))
    profiler.reset()
    full = tlt.make_batch(3, H, W, GRID, draws)
    st = profiler.stats()
    n_valid = full.pos_mask.sum(1)
    assert int(n_valid.min()) > 16
    assert st["loftr_train/gt_dropped"]["count"] == 0
    assert st["loftr_train/gt_pos"]["count"] == int(n_valid.sum())
    assert torch.equal(full.i_ids.sort(1)[0], torch.arange(GRID).expand(3, -1))
    profiler.reset()
    cut = tlt.make_batch(3, H, W, 16, draws)
    st = profiler.stats()
    assert bool(cut.pos_mask.all())
    assert st["loftr_train/gt_pos"]["count"] == 3 * 16
    assert st["loftr_train/gt_dropped"]["count"] == int(n_valid.sum()) - 3 * 16
    for p in range(3):
        assert torch.equal(cut.i_ids[p], full.i_ids[p][full.pos_mask[p]][:16])


def test_fine_cells_draw_valid_cells_without_replacement():
    draws = tlt.draw_pair(2, H, W, torch.Generator().manual_seed(5))
    b = tlt.make_batch(2, H, W, GRID, draws)
    n_valid = b.pos_mask.sum(1)
    u = torch.rand(2, GRID, generator=torch.Generator().manual_seed(6))
    few = tlt.fine_cells(b, 10, u)
    assert few.i_ids.shape == (2, 10) and bool(few.pos_mask.all())
    for p in range(2):
        assert len(set(few.i_ids[p].tolist())) == 10
        valid = set(b.i_ids[p][b.pos_mask[p]].tolist())
        assert set(few.i_ids[p].tolist()) <= valid
    sel = rt.fine_order(b.pos_mask, u, 10)
    assert torch.equal(few.i_ids, torch.gather(b.i_ids, 1, sel))
    assert torch.equal(few.pts1, torch.gather(b.pts1, 1, sel[..., None].expand(-1, -1, 2)))
    many = tlt.fine_cells(b, GRID, u)          # more than are valid: padded
    for p in range(2):
        k = int(n_valid[p])
        assert bool(many.pos_mask[p, :k].all()) and not bool(many.pos_mask[p, k:].any())
        assert sorted(many.i_ids[p].tolist()) == list(range(GRID))
    g = torch.Generator().manual_seed(7)
    assert not torch.equal(tlt.fine_cells(b, 10, generator=g).i_ids,
                           tlt.fine_cells(b, 10, generator=g).i_ids)
    with pytest.raises(ValueError):
        tlt.fine_cells(b, GRID + 1, u)


def test_entry_takes_max_gt_and_fine_gt(tmp_path):
    """``--max_gt`` and ``--fine_gt`` reach the step: the counters read the
    fine windows and no dropped cell at the whole grid."""
    out = str(tmp_path / "w.pt")
    profiler.reset()
    assert tlt.main(["--steps", "2", "--size", "64", "--batch", "2", "--max_gt", str(GRID),
                     "--fine_gt", "12", "--out", out, "--device", "cpu",
                     "--log_every", "1"]) == 0
    st = profiler.stats()
    assert st["loftr_train/pairs"]["count"] == 4
    assert st["loftr_train/fine_windows"]["count"] == 2 * 2 * 12
    assert st["loftr_train/gt_dropped"]["count"] == 0
    assert st["loftr_train/gt_pos"]["count"] > 0
    assert "backbone.conv1.weight" in torch.load(out)["state_dict"]


@pytest.mark.parametrize("hw,K", [((64, 64), 12), ((64, 96), 20)])
def test_step_flops_match_flop_counter(hw, K):
    """One forward and backward of the trainer's loss, the fine branch at K
    cells."""
    tcfg = tlt.TrainCfg(H=hw[0], W=hw[1], batch=2, max_gt=(hw[0] // 8) * (hw[1] // 8),
                        fine_gt=K)
    module = port_module(rl.make_weights(3, W_))
    tlt.trainable(module)
    b = tlt.make_batch(2, hw[0], hw[1], tcfg.max_gt, generator=torch.Generator().manual_seed(0))
    fine = tlt.fine_cells(b, K, generator=torch.Generator().manual_seed(1))
    loss_fn = tlt.make_loss_fn(module, tcfg)
    with FlopCounterMode(display=False) as fc:
        loss, _ = loss_fn(b, fine)
        loss.backward()
    assert fc.get_total_flops() == 2 * loftr_train_costs.step_flops(W_, *hw, K)


def test_published_step_flops():
    """An 840 x 840 pair with 2,205 fine windows: 3 x the forward's 1,745
    GFLOP, less the images' and the grid's gradients."""
    fwd = loftr_costs.pair_flops(rl.CVPR_DS, 840, 840, 2205)
    step = loftr_train_costs.step_flops(rl.CVPR_DS, 840, 840, 2205)
    assert round(fwd / 1e9) == 1745
    assert 0.999 * 3 * fwd < step < 3 * fwd
