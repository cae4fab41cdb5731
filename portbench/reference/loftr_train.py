"""Plain PyTorch reference of LoFTR's training step (Sun et al., CVPR 2021;
https://github.com/zju3dv/LoFTR, ``src/losses/loftr_loss.py``), in float32
with TF32 off.  It imports nothing of the program.

- the forward: ``reference/loftr.py``'s backbone, positional encoding,
  coarse transformer and dual softmax, and its fine stage teacher-forced at
  given cells, with the window and the BatchNorm of the departures below;
- the loss: the focal coarse loss over the dense labels
  (``compute_coarse_loss``, focal: alpha 0.25, gamma 2, the confidence
  clamped to [1e-6, 1 - 1e-6], the positives' and the negatives' means)
  plus ``fine_weight`` times the fine l2 loss;
- the gradients by autograd, the BatchNorm statistics among the leaves;
- the update: optax's ``clip_by_global_norm(1.0)``, then ``adamw`` (b1 0.9,
  b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf) at
  ``warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)`` read at the
  update count before it rises, so the first update runs at lr 0.

The fine cells of a step are drawn as the program draws them from the same
uniforms: each pair's valid GT cells in a uniform order, then the invalid
ones (``fine_order``).

Departures from the upstream's recipe, each the JAX trainer's, which the
program reproduces:

- the fine branch is teacher-forced at GT cells; the upstream runs it at
  its predicted coarse matches, padded with GT cells;
- BatchNorm runs at its running statistics, and those statistics are
  trained as AdamW leaves (flax's ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``, which autograd differentiates in them); the upstream
  trains BatchNorm on batch statistics;
- the optimizer is clip + AdamW with a warmup-cosine schedule; the
  upstream runs AdamW with a linear warmup and MultiStepLR;
- the fine l2 loss is in fine-map units (image px / 2), over every valid
  cell, at the cell's exact pixel; the upstream normalises the offset by
  the window's radius and keeps only offsets inside the window
  (``correct_thr``);
- a fine window is clamped at the fine map's border (the map padded by
  replicating its edge), as the program's is; the upstream's ``F.unfold``
  pads with zeros;
- the means divide by their counts; the program adds 1e-6 to each.

Its convolutions run with cuDNN off (PyTorch's own im2col and GEMM): in
float32 with TF32 off cuDNN picks FFT tilings that need tens of GB at 840 x
840 (``models/loftr.py::_without_cudnn``).

A batch is computed in blocks of ``block`` pairs (1 at the published
sizes): each block's loss terms are divided by the whole batch's counts
(its positives, its negatives, its fine weights) and the gradients of the
blocks are summed.  That is exact, as the losses are sums over pairs.

``precision="tf32"`` is the control, one precision below: both switches
on, and every operand of a convolution, linear layer and product of the
forward rounded to TF32 (``reference/loftr.py::tf32_round``; the gradient
passes the rounding unchanged).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import loftr as rl

ALPHA = 0.25
GAMMA = 2.0
CLAMP = 1e-6
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4
MAX_NORM = 1.0


def _ste_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 in the forward, the identity in the backward."""
    d = t.detach()
    return t + (rl.tf32_round(d) - d)


@contextlib.contextmanager
def _without_cudnn():
    old = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = old


class _TrainOps(rl._Ops):
    """``reference/loftr.py``'s products, with a rounding that gradients
    pass and a BatchNorm that is differentiable in its statistics."""

    def __init__(self, sd: dict, precision: str):
        super().__init__(sd, precision)
        if precision == "tf32":
            self.r = _ste_tf32

    def bn(self, x, name):
        s = self.sd
        mul = torch.rsqrt(s[f"{name}.running_var"] + rl.BN_EPS) * s[f"{name}.weight"]
        return ((x - s[f"{name}.running_mean"][:, None, None]) * mul[:, None, None]
                + s[f"{name}.bias"][:, None, None])


def fine_order(pos_mask: torch.Tensor, u: torch.Tensor, fine_gt: int) -> torch.Tensor:
    """The positions (B, fine_gt) in a batch's GT cells that the fine branch
    takes: the valid cells in decreasing ``u``, then the invalid ones."""
    key = torch.where(pos_mask, u, u - 2.0)
    return torch.sort(key, dim=1, descending=True, stable=True)[1][:, :fine_gt]


def fine_stage(o, w: dict, ff0, ff1, fc0, fc1, Wc: int, scale: int, i_ids, j_ids):
    """``reference/loftr.py::fine_at`` with its windows clamped at the fine
    map's border: mkpts1_f (B, K, 2) in input pixels."""
    B, K = i_ids.shape
    W = w["window"]
    WW, r = W * W, W // 2
    Hc = fc0.shape[1] // Wc
    stride = ff0.shape[2] // Hc
    scale_f = scale // stride

    def unfold(ff):
        u = F.unfold(F.pad(ff, (r, r, r, r), mode="replicate"), kernel_size=(W, W),
                     stride=stride)
        return u.view(B, ff.shape[1], WW, -1).permute(0, 3, 2, 1)   # (B, L, WW, C)

    b = torch.arange(B, device=i_ids.device)[:, None]
    w0, w1 = unfold(ff0)[b, i_ids], unfold(ff1)[b, j_ids]
    c_win = o.linear(torch.cat([fc0[b, i_ids], fc1[b, j_ids]], 0), "fine_preprocess.down_proj")
    merged = o.linear(torch.cat([torch.cat([w0, w1], 0),
                                 c_win[:, :, None].expand(-1, -1, WW, -1)], -1),
                      "fine_preprocess.merge_feat")
    df = merged.shape[-1]
    g0, g1 = merged.reshape(2, B * K, WW, df)
    g0, g1 = rl.transformer(o, g0, g1, "loftr_fine", w["fine_pairs"], w["nhead"])
    sim = o.einsum("mc,mrc->mr", g0[:, WW // 2, :], g1)
    heat = torch.softmax(sim / df ** 0.5, dim=1).view(-1, W, W)
    lin = torch.linspace(-1.0, 1.0, W, device=heat.device)
    coords = torch.stack([(heat.sum(1) * lin).sum(-1), (heat.sum(2) * lin).sum(-1)], -1)
    mkpts1_c = torch.stack([j_ids % Wc, j_ids // Wc], -1).float() * scale
    return mkpts1_c + (coords * r * scale_f).view(B, K, 2)


def forward(o, w: dict, img0, img1, i_ids, j_ids) -> tuple:
    """The training forward of a block of pairs: the confidence matrix
    (B, L, S) and the fine position (B, K, 2) at the cells (i_ids, j_ids)."""
    B = img0.shape[0]
    fc, ff = rl.backbone(o, torch.cat([img0, img1], 0))
    _, C, Hc, Wc = fc.shape
    fc = fc + rl.sine_encoding(C, Hc, Wc, w["temp_bug_fix"], fc.device)
    fcl = fc.flatten(2).transpose(1, 2)
    f0, f1 = rl.transformer(o, fcl[:B], fcl[B:], "loftr_coarse", w["coarse_pairs"], w["nhead"])
    sim = o.einsum("nlc,nsc->nls", f0 / C ** 0.5, f1 / C ** 0.5) / w["dsmax_temp"]
    conf = F.softmax(sim, 1) * F.softmax(sim, 2)
    mk = fine_stage(o, w, ff[:B], ff[B:], f0, f1, Wc, img0.shape[2] // Hc, i_ids, j_ids)
    return conf, mk


def block_loss(conf, gt, mkpts1_f, pts1, fine_pos, counts: dict, fine_weight: float):
    """A block's part of the batch's loss: its focal sums over the batch's
    positive and negative counts, its fine l2 sum over the batch's fine
    weight."""
    c = torch.clamp(conf, CLAMP, 1 - CLAMP)
    pos, neg = c[gt], c[~gt]
    lc = (-ALPHA * torch.pow(1 - pos, GAMMA) * pos.log()).sum() / counts["pos"]
    lc = lc + (-ALPHA * torch.pow(neg, GAMMA) * (1 - neg).log()).sum() / counts["neg"]
    off = ((mkpts1_f - pts1) / 2.0) ** 2
    lf = off.sum(-1)[fine_pos].sum() / counts["fine"]
    return lc + fine_weight * lf


def losses_and_grads(params: dict, w: dict, batch: dict, u, fine_gt, fine_weight: float,
                     precision: str = "ref", block: int = 1, keep_conf: bool = False) -> dict:
    """One step's loss and gradients (by name) on ``batch`` (img0,
    img1 (B, 1, H, W); i_ids, j_ids, pos_mask (B, K); pts1 (B, K, 2)), the
    fine branch at the cells ``fine_order`` takes from ``u`` (``fine_gt``
    None: all K).  ``params``: leaf tensors that require grad.  With
    ``keep_conf``, each pair's confidence matrix (detached) too."""
    B, K = batch["i_ids"].shape
    if fine_gt is None:
        sel = torch.arange(K, device=batch["i_ids"].device).expand(B, K)
    else:
        sel = fine_order(batch["pos_mask"], u, fine_gt)
    fine = {k: torch.gather(batch[k], 1, sel) for k in ("i_ids", "j_ids", "pos_mask")}
    fine["pts1"] = torch.gather(batch["pts1"], 1, sel[..., None].expand(-1, -1, 2))
    img0, img1 = batch["img0"], batch["img1"]
    L = (img0.shape[2] // 8) * (img0.shape[3] // 8)
    n_pos = int(batch["pos_mask"].sum())
    counts = {"pos": n_pos, "neg": B * L * L - n_pos, "fine": int(fine["pos_mask"].sum())}
    for p in params.values():
        p.grad = None
    out = {"loss": 0.0, "conf": []}
    with rl._matmul_precision(precision), _without_cudnn():
        o = _TrainOps(params, precision)
        for s in range(0, B, block):
            e = min(s + block, B)
            conf, mk = forward(o, w, img0[s:e], img1[s:e], fine["i_ids"][s:e],
                               fine["j_ids"][s:e])
            gt = torch.zeros_like(conf, dtype=torch.bool)
            bb = torch.arange(e - s, device=conf.device)[:, None].expand(-1, K)
            gt[bb, batch["i_ids"][s:e], batch["j_ids"][s:e]] = batch["pos_mask"][s:e]
            loss = block_loss(conf, gt, mk, fine["pts1"][s:e], fine["pos_mask"][s:e], counts,
                              fine_weight)
            loss.backward()
            out["loss"] += float(loss.detach())
            if keep_conf:
                out["conf"] += list(conf.detach())
            del conf, mk, gt, loss
    out["grads"] = {k: p.grad.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return out


def schedule(count: int, lr: float, warmup: int, decay_steps: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)``."""
    if count < warmup:
        return lr * count / warmup
    T = decay_steps - warmup
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, T) / T))


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, lr: float) -> None:
    """optax ``clip_by_global_norm(1.0)`` then ``adamw`` at ``lr``, in place
    (``state``: count, mu, nu)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    state["count"] += 1
    t = state["count"]
    for k, p in params.items():
        g = torch.where(norm < MAX_NORM, grads[k], grads[k] / norm * MAX_NORM)
        mu = state["mu"][k].mul_(B1).add_((1 - B1) * g)
        nu = state["nu"][k].mul_(B2).add_((1 - B2) * g * g)
        step = (mu / (1 - B1 ** t)) / (torch.sqrt(nu / (1 - B2 ** t)) + EPS)
        p.sub_(lr * (step + WEIGHT_DECAY * p))


def train(sd: dict, w: dict, batches: list, us: list, hyper: dict, device,
          precision: str = "ref", block: int = 1) -> dict:
    """Steps from the weights ``sd`` (a state dict, on any device) over
    ``batches`` (dicts as ``losses_and_grads`` takes them) and the fine
    draws ``us``; ``hyper``: lr, warmup, decay_steps, fine_gt,
    fine_weight.  Returns each step's loss and gradients (before the clip),
    the first step's confidence matrices, a pair each, and each leaf's
    change after the steps, on ``device``."""
    params = {k: v.detach().to(device).clone().requires_grad_(True) for k, v in sd.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    state = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    out = {"losses": [], "grads": [], "conf": None}
    for i, (batch, u) in enumerate(zip(batches, us)):
        b = {k: v.to(device) for k, v in batch.items()}
        res = losses_and_grads(params, w, b, None if u is None else u.to(device),
                               hyper["fine_gt"], hyper["fine_weight"], precision, block,
                               keep_conf=i == 0)
        if i == 0:
            out["conf"] = res["conf"]
        out["losses"].append(res["loss"])
        out["grads"].append(res["grads"])
        lr = schedule(state["count"], hyper["lr"], hyper["warmup"], hyper["decay_steps"])
        update(params, res["grads"], state, lr)
    out["change"] = {k: (params[k] - start[k]).detach() for k in params}
    return out
