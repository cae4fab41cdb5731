"""Window driver ``loftr_train``: LoFTR's training step
(``models/loftr_train.py``) at the configuration's widths, resolution,
batch and supervision, on ``make_batch`` homography pairs.

Set-up builds the module at the configuration's widths with weights drawn
from the seed (``reference/loftr.py::make_weights``), the trainer's
``LoftrOptimizer`` and its step (``make_train_step``), and a generator on
the device seeded with ``--seed``, as ``train_loftr`` does.  It trains the
first ``check_steps`` (3) steps on ``make_batch`` pairs and fine draws taken from that
generator in the order the step takes them itself, keeping each batch, its
fine draws, its loss, the gradients before the clip, the first step's
confidence matrices and each leaf's change after the third step (optax's
first update runs at lr 0); then ``warm_steps`` steps more.  A step in the
window and the traced slice is ``step(generator=...)``, as in
``train_loftr``, and reads its loss back: a non-finite loss is a failed
step.

The check runs after the program's state is freed: the plain reference
(``reference/loftr_train.py``) trains the same steps from the same
weights on the same batches and draws, pair by pair, and

- ``loss_gap``: each step's loss, the relative gap, the worst step;
- ``grad_gap``: the gradients before the clip of the steps that start
  from the seed's weights on both sides, the first two (optax's first
  update runs at lr 0), each leaf's L2 gap over the larger of its norm and
  the median leaf's (``leaf_gaps``), the worst leaf and step.  A leaf
  whose gradient is a small part of the others' (the attention's query
  and key projections, under 1 % of the median) sums terms that mostly
  cancel, and the focal loss's clamp at 1e-6 turns a cell's term on or off
  as its confidence rounds, so measured against its own norm such a leaf
  moves by percents between two float32 summing orders.  The third step
  starts from weights that the second update's rounding moved, through
  Adam's normalised update of the smallest gradients, and its gradients
  differ by 0.3-1.6 % (on the card, PERF.md §6): its effect is read in
  ``change_gap``;
- ``change_gap``: each leaf's change after the steps, the same gap, the
  worst leaf (of the leaves whose first gradient is at least a thousandth
  of the median leaf's: below that Adam's normalised update follows the
  rounding of a gradient that is nearly nothing);
- ``conf_gap``: the first step's confidence matrix, pair by pair, the
  relative L2 gap, the worst pair;
- ``gt_dropped``: the program's counter of valid cells left out of the
  coarse labels, over set-up and the window;
- ``failed``: the window's steps with a non-finite loss.
"""
from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from ..reference import loftr as ref_loftr
from ..reference import loftr_train as ref_train
from . import common

# the checked steps that start from the seed's weights on both sides
SAME_WEIGHTS = 2
BATCH_KEYS = ("img0", "img1", "i_ids", "j_ids", "pts1", "pos_mask")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def leaf_gaps(got: dict, ref: dict, keep: list) -> dict:
    """Each kept leaf's L2 gap over the larger of its reference norm and the
    median kept leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    floor = statistics.median(norms.values())
    return {k: float((got[k].double() - ref[k].double()).norm()) / max(norms[k], floor, 1e-30)
            for k in keep}


def train_config(tlt, config: dict):
    """The trainer's ``TrainCfg`` from the configuration's ``train``."""
    t = config["train"]
    return tlt.TrainCfg(H=int(t["H"]), W=int(t["W"]), batch=int(t["batch"]),
                        max_gt=int(t["max_gt"]), lr=float(t["lr"]), warmup=int(t["warmup"]),
                        fine_weight=float(t["fine_weight"]), fine_gt=t["fine_gt"])


def widths(config: dict) -> dict:
    """The LoFTR widths of the configuration, under ``CVPR_DS``'s keys."""
    w = {k: config["loftr"][k] for k in ref_loftr.CVPR_DS}
    w["block_dims"] = tuple(w["block_dims"])
    return w


class Cell:
    def __init__(self, ctx):
        from bundlesdf_tpu_torch.models import loftr as lt
        from bundlesdf_tpu_torch.models import loftr_train as tlt
        from bundlesdf_tpu_torch.utils import profiler

        self.ctx = ctx
        if float(ctx.traffic["depth_frac"]) != 0:
            raise ValueError("the cell trains on make_batch pairs alone (depth_frac 0)")
        self.tcfg = tcfg = train_config(tlt, ctx.config)
        self.n_steps = int(ctx.config["train"]["n_steps"])
        self.widths = widths(ctx.config)
        dev = ctx.device
        self.sd = ref_loftr.make_weights(ctx.seed, self.widths)
        module = lt.load_weights(lt.LoftrModule(lt.LoftrCfg(**self.widths)), self.sd)
        module = module.to(dev).train()
        leaves = tlt.trainable(module)
        self.names = ([n for n, _ in module.named_parameters()]
                      + [n for n, b in module.named_buffers()
                         if n.endswith(("running_mean", "running_var"))])
        kept = []

        class Recording(tlt.LoftrOptimizer):
            """The trainer's optimizer, keeping the gradients before the
            clip while ``kept`` is open."""

            def step(self):
                if kept and kept[-1] is None:
                    kept[-1] = [p.grad.detach().cpu().clone() for p in self.leaves]
                super().step()

        self.optimizer = Recording(leaves, tcfg, self.n_steps)
        self.step = tlt.make_train_step(module, tcfg, self.optimizer)
        self.module = module
        self.gen = torch.Generator(device=dev).manual_seed(int(ctx.seed))
        self.failed = 0
        profiler.reset()

        forward, confs = module.forward, []

        def keep_conf(img0, img1, gt_ids=None):
            out = forward(img0, img1, gt_ids)
            if not confs:
                confs.append(out["conf_matrix"].detach())
            return out

        module.forward = keep_conf
        first = {"batches": [], "fine_u": [], "losses": []}
        for _ in range(int(ctx.traffic["check_steps"])):
            batch = tlt.make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt, generator=self.gen,
                                   device=dev)
            u = None
            if tcfg.fine_gt is not None:   # the step's own draw, after the batch
                u = torch.rand(tuple(batch.i_ids.shape), generator=self.gen, device=dev)
            kept.append(None)
            m = self.step(batch, fine_u=u)
            first["losses"].append(float(m["loss"]))
            first["batches"].append({k: v.cpu() for k, v in zip(BATCH_KEYS, batch)})
            first["fine_u"].append(None if u is None else u.cpu())
        del module.forward
        first["conf"] = confs.pop().cpu()
        first["grads"] = [dict(zip(self.names, g)) for g in kept]
        first["change"] = {n: p.detach().cpu() - self.sd[n] for n, p in zip(self.names, leaves)}
        self.first = first
        kept.clear()
        self._steps(steps=int(ctx.traffic["warm_steps"]))
        common.sync(dev)
        self.dropped = profiler.stats().get("loftr_train/gt_dropped", {"count": 0})["count"]

    def _steps(self, seconds: float = float("inf"), steps: int | None = None) -> tuple:
        """Train until ``seconds`` have passed or ``steps`` are done: (steps,
        those with a non-finite loss)."""
        done = bad = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and (steps is None or done < steps):
            loss = float(self.step(generator=self.gen)["loss"])
            bad += 0 if math.isfinite(loss) else 1
            done += 1
        return done, bad

    def window(self, seconds: float) -> dict:
        from bundlesdf_tpu_torch.utils import profiler

        profiler.reset()
        common.sync(self.ctx.device)
        t0 = time.perf_counter()
        steps, bad = self._steps(seconds=seconds)
        common.sync(self.ctx.device)
        window_s = time.perf_counter() - t0
        spans = profiler.stats()
        self.dropped += spans.get("loftr_train/gt_dropped", {"count": 0})["count"]
        self.failed = bad
        return {"steps": steps, "window_s": window_s, "attempted": steps, "failed": bad,
                "spans": spans}

    def traced_slice(self) -> int:
        with common.span_labels():
            return self._steps(steps=int(self.ctx.traffic["trace_steps"]))[0]

    def numbers(self, precision: str = "ref") -> dict:
        """The check's numbers against the reference at ``precision``, with
        the readings they come from."""
        hyper = {"lr": self.tcfg.lr, "warmup": self.tcfg.warmup,
                 "decay_steps": max(self.n_steps, self.tcfg.warmup + 1),
                 "fine_gt": self.tcfg.fine_gt, "fine_weight": self.tcfg.fine_weight}
        f = self.first
        ref = ref_train.train(self.sd, self.widths, f["batches"], f["fine_u"], hyper,
                              self.ctx.device, precision)
        loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(f["losses"], ref["losses"])]
        cpu = [{k: v.cpu() for k, v in r.items()} for r in ref["grads"]]
        norms = {k: float(v.double().norm()) for k, v in cpu[0].items()}
        moved = [k for k, v in norms.items() if v >= 1e-3 * statistics.median(norms.values())]
        grad = [leaf_gaps(g, r, list(r)) for g, r in zip(f["grads"][:SAME_WEIGHTS], cpu)]
        change = leaf_gaps(f["change"], {k: v.cpu() for k, v in ref["change"].items()}, moved)
        conf = [_rel(f["conf"][p], c.cpu()) for p, c in enumerate(ref["conf"])]
        out = {"loss_gap": max(loss), "grad_gap": max(max(g.values()) for g in grad),
               "change_gap": max(change.values()), "conf_gap": max(conf),
               "details": {"loss": loss, "conf": conf,
                           "grad": [sorted(((v, k) for k, v in g.items()), reverse=True)[:3]
                                    for g in grad],
                           "grad_every_step": [max(leaf_gaps(g, r, list(r)).values())
                                               for g, r in zip(f["grads"], cpu)],
                           "change": sorted(((v, k) for k, v in change.items()),
                                            reverse=True)[:3],
                           "left_out": sorted(set(norms) - set(moved))}}
        del ref, cpu
        common.free(self.ctx.device)
        return out

    def release(self) -> None:
        """Free the program's state (the reference runs alone on the card)."""
        self.module = self.step = self.optimizer = self.gen = None
        common.free(self.ctx.device)

    def verify(self) -> list:
        self.release()
        nums = self.numbers()
        print(f"portbench: loftr_train details {nums.pop('details')}", file=sys.stderr)
        nums["gt_dropped"] = float(self.dropped)
        nums["failed"] = float(self.failed)
        limits = self.ctx.limits
        return [{"name": k, "value": float(v), "limit": float(limits[k])}
                for k, v in nums.items() if k in limits]
