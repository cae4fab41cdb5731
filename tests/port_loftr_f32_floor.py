"""The f32 floor of the LoFTR trainer's gradients, on the CPU (not collected
by pytest; run ``PYTHONPATH=. python3 tests/port_loftr_f32_floor.py``).

One step of ``bundlesdf_tpu_torch.models.loftr_train`` at ``TrainCfg()``
(160 x 160 pairs, batch 8, max_gt 256) and full LoFTR width, from the
seeded init on one seeded homography batch, in f32 and in f64: the loss,
each leaf's relative L2 gradient difference (the largest printed), and the
dual-softmax confidence at the GT cells against the focal loss's 1e-6 clip.
``chip_smoke.py``'s card-against-CPU bound for this step
(``LOFTR_TRAIN_GRAD_RTOL``) sits above what it prints.  About 30 s on 8
cores.
"""
import numpy as np
import torch

from bundlesdf_tpu_torch.models import loftr
from bundlesdf_tpu_torch.models import loftr_train as lt


def _fine_expectation_any_dtype(w0f, w1f, W):
    """models/loftr.py::fine_expectation with its grid in the features'
    dtype (the module's is f32)."""
    WW, C = W * W, w0f.shape[-1]
    heat = torch.softmax(torch.einsum("mc,mrc->mr", w0f[:, WW // 2, :], w1f) / C ** 0.5, dim=1)
    ax = torch.arange(W, dtype=w0f.dtype) / (W // 2) - 1.0
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    return heat @ torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def one_step(batch, tcfg, dtype):
    module = loftr.init_weights(loftr.LoftrModule(), seed=0).train().to(dtype)
    lt.trainable(module)
    b = lt.HomographyBatch(*(t.to(dtype) if t.is_floating_point() else t for t in batch))
    loss, _ = lt.make_loss_fn(module, tcfg)(b)
    loss.backward()
    grads = {n: p.grad.double() for n, p in module.named_parameters()}
    with torch.no_grad():
        conf = module(b.img0, b.img1, gt_ids=(b.i_ids, b.j_ids))["conf_matrix"]
        rows = torch.arange(tcfg.batch)[:, None].expand_as(b.i_ids)
        gt_conf = conf[rows, b.i_ids, b.j_ids][b.pos_mask].double()
    return float(loss.detach()), grads, gt_conf


def main():
    torch.set_num_threads(8)
    loftr.fine_expectation = _fine_expectation_any_dtype
    tcfg = lt.TrainCfg()
    batch = lt.make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt,
                          generator=torch.Generator().manual_seed(1), device="cpu")
    l32, g32, _ = one_step(batch, tcfg, torch.float32)
    l64, g64, conf = one_step(batch, tcfg, torch.float64)
    err = {k: float((g32[k] - g64[k]).norm() / g64[k].norm()) for k in g64}
    print(f"loss f32 {l32} f64 {l64}")
    print("largest f32-vs-f64 relative L2 gradient differences:")
    for k, v in sorted(err.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {k}: {v:.3e}")
    print(f"GT cells {len(conf)}: conf < 1e-6: {int((conf < 1e-6).sum())}, "
          f"within 10% of 1e-6: {int(((conf > 0.9e-6) & (conf < 1.1e-6)).sum())}, "
          f"median {float(conf.median()):.3e}")


if __name__ == "__main__":
    main()
