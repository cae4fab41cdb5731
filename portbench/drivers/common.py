"""What the drivers share: the program's configs built from a
configuration file, the three first steps read from the program's state,
and their comparison with the plain reference."""
from __future__ import annotations

import contextlib
import os
import statistics
import sys

import numpy as np
import torch

from ..reference import nof_step

# The online loop scales the scene bounds by 0.7 (the reference's online
# margin, bundlesdf.py:151); the offline refinement reuses that
# normalization.
ONLINE_MARGIN = 0.7


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Return the freed program state's cached blocks to the device."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def span_labels():
    """While a slice is traced, every span of the program also opens a
    profiler range of its name, so that the trace names the host work open
    around each idle gap."""
    from bundlesdf_tpu_torch.utils import profiler

    plain = profiler.span

    @contextlib.contextmanager
    def labelled(name):
        with torch.profiler.record_function(name), plain(name):
            yield

    users = [m for name, m in list(sys.modules.items())
             if name.split(".")[0] == "bundlesdf_tpu_torch" and getattr(m, "span", None) is plain]
    for m in users:
        m.span = labelled
    try:
        yield
    finally:
        for m in users:
            m.span = plain


def nof_config(config: dict, tmp: str):
    """The program's NOF config: the configuration file's ``nof`` section,
    its checkpoint folder under the run's temporary directory."""
    from bundlesdf_tpu_torch.config import Cfg

    return Cfg.wrap(dict(config)).merged({"save_dir": os.path.join(tmp, "nof")})


def track_config(config: dict, tmp: str):
    """The program's tracker config: the file's ``track`` section, its debug
    folder under the run's temporary directory."""
    from bundlesdf_tpu_torch.config import Cfg

    return Cfg.wrap(dict(config)).merged({"debug_dir": os.path.join(tmp, "debug")})


def as_leaves(params: dict) -> dict:
    """The benchmark's weights as the program takes them: float32 leaf
    tensors that require grad."""
    if isinstance(params, dict):
        return {k: as_leaves(v) for k, v in params.items()}
    return params.detach().clone().contiguous().requires_grad_(True)


def unflatten(flat: dict, device) -> dict:
    out = {}
    for name, t in flat.items():
        node = out
        *head, last = name.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = t.to(device).clone()
    return out


def _norms(cfg: dict, params: dict) -> dict:
    return {n: float(t.detach().double().norm())
            for n, t in nof_step.compared_leaves(cfg, params).items()}


def first_steps(runner, n: int, draws) -> dict:
    """Train ``n`` steps through ``train_advance`` (one step, then a drain,
    each) from the runner's present state.  Returns each step's loss, each
    compared leaf's norm of the gradient Adam got in the first step (from
    its moment: ``(m1 - B1 m0) / (1 - B1)``) and of its change after the
    ``n`` steps, and the draws the steps used (on the CPU)."""
    opt = runner.optimizer
    if len(opt.groups) != 1:
        raise ValueError("one optimizer group is the configuration here")
    group = opt.groups[0]
    flat = dict(nof_step.named_leaves(runner.params))
    index = {id(p): i for i, p in enumerate(group["params"])}
    slot = {name: index[id(t)] for name, t in flat.items()}
    runner.train_drain()
    sync(runner.device)
    with torch.no_grad():
        p0 = {k: t.detach().clone() for k, t in flat.items()}
        m0 = {k: group["exp_avg"][slot[k]].clone() for k in flat}
    draws.record(True)
    losses, grad = [], None
    for i in range(n):
        runner.train_advance(1)
        losses.append(runner.train_drain()["loss"])
        if i == 0:
            with torch.no_grad():
                grad = {k: (group["exp_avg"][slot[k]] - nof_step.B1 * m0[k]) / (1 - nof_step.B1)
                        for k in flat}
    recorded = draws.record(False)
    cfg = runner.cfg
    with torch.no_grad():
        change = {k: flat[k].detach() - p0[k] for k in flat}
        out = {"losses": losses,
               "grad_norms": _norms(cfg, unflatten(grad, grad["table"].device)),
               "change_norms": _norms(cfg, unflatten(change, change["table"].device)),
               "draws": [(nr, idx.cpu(), tuple(None if u is None else u.cpu() for u in us))
                         for nr, idx, us in recorded]}
    return out


def snapshot(runner) -> tuple:
    """The runner's parameters and Adam state, on the CPU (the start of a
    comparison that follows the program from its own state)."""
    group = runner.optimizer.groups[0]
    index = {id(p): i for i, p in enumerate(group["params"])}
    flat = dict(nof_step.named_leaves(runner.params))
    with torch.no_grad():
        params = {k: t.detach().cpu().clone() for k, t in flat.items()}
        adam = {"count": int(runner.optimizer.count),
                "m": {k: group["exp_avg"][index[id(t)]].detach().cpu().clone()
                      for k, t in flat.items()},
                "v": {k: group["exp_avg_sq"][index[id(t)]].detach().cpu().clone()
                      for k, t in flat.items()}}
    return params, adam


def leaf_gaps(got: dict, ref: dict, keep) -> dict:
    """Each kept leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median kept
    leaf's."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def reference_steps(cfg: dict, params0: dict, adam0: dict, pool: dict, draws: list, device,
                    microbatches: int, precision: str = "ref", drop_half: bool = False) -> dict:
    """The reference over the recorded draws from ``params0`` and ``adam0``
    (CPU tensors, flat names): losses, and per compared leaf the first
    gradient's norm and the change's norm."""
    params = unflatten(params0, device)
    adam = {"count": adam0["count"],
            "m": {k: v.to(device).clone() for k, v in adam0["m"].items()},
            "v": {k: v.to(device).clone() for k, v in adam0["v"].items()}}
    rays = torch.from_numpy(pool["rays"]).to(device)
    grid = pool["grid"].to(device)
    c2w = torch.from_numpy(pool["c2w"]).to(device)
    dr = [(nr, idx.to(device), tuple(None if u is None else u.to(device) for u in us))
          for nr, idx, us in draws]
    start = {k: v.to(device) for k, v in params0.items()}
    res = nof_step.train(cfg, params, adam, rays, grid, c2w, dr, precision, microbatches,
                         drop_half)
    after = dict(nof_step.named_leaves(params))
    change = unflatten({k: after[k] - start[k] for k in after}, device)
    out = {"losses": res["losses"],
           "grad_norms": _norms(cfg, unflatten(res["first_grad"], device)),
           "change_norms": _norms(cfg, change)}
    del params, adam, rays, grid, c2w, dr, start, after, change, res
    free(device)
    return out


def step_numbers(cfg: dict, got: dict, ref: dict) -> dict:
    """The numbers a training check can compare, with the details they come
    from: each step's relative loss gap (``loss_gap`` the worst step,
    ``loss_gap.first`` the first, which both sides compute from the same
    weights); each leaf's first-gradient and change gap (``leaf_gaps``),
    the change over the leaves whose reference first gradient is at least a
    thousandth of the median leaf's (the others move under Adam by
    round-off alone).  ``grad_gap`` and ``change_gap`` are the worst leaf.
    ``grad_gap.f32`` takes the leaves that are not staged in bfloat16 (the
    MLPs, the pose corrections, the small levels), each side's norms over
    its own norm of those leaves together: the clip scales every leaf by
    one factor, the global max, which a bf16 level sets when it holds the
    largest entry."""
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"])]
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    every = list(g_ref)
    moved = [k for k in every if g_ref[k] >= 1e-3 * g_med]
    staged = {f"table.L{i}" for i, p in enumerate(nof_step.grid_levels(cfg)) if p["staged"]}
    f32 = [k for k in every if k not in staged]

    def unit(norms):
        total = sum(norms[k] ** 2 for k in f32) ** 0.5
        return {k: norms[k] / max(total, 1e-30) for k in f32}

    grad = leaf_gaps(got["grad_norms"], g_ref, every)
    change = leaf_gaps(got["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": max(loss), "loss_gap.first": loss[0],
            "grad_gap": max(grad.values()),
            "grad_gap.f32": max(leaf_gaps(unit(got["grad_norms"]), unit(g_ref), f32).values()),
            "change_gap": max(change.values()),
            "details": {"loss": loss, "grad": grad, "change": change,
                        "left_out": [k for k in every if k not in moved],
                        "grad_norms": {"program": got["grad_norms"], "reference": g_ref}}}


def compare_first_steps(cfg: dict, params0: dict, adam0: dict, pool: dict, first: dict,
                        device, microbatches: int, limits: dict) -> list:
    ref = reference_steps(cfg, params0, adam0, pool, first["draws"], device, microbatches)
    nums = step_numbers(cfg, first, ref)
    return [{"name": k, "value": float(v), "limit": float(limits[k])}
            for k, v in nums.items() if k in limits]


def pose_checks(sessions: list, model_pts: np.ndarray, limits: dict) -> list:
    """Every frame of every session against the truth: the largest ADD
    (first frame aligned, mm), the largest frame-to-frame motion ADD (mm)
    and the FAIL frames; those of them that the cell has a limit for."""
    from ..accuracy import session_errors

    add, motion, fails = [0.0], [0.0], 0
    for s in sessions:
        fails += s["fails"]
        if len(s["preds"]) < 2:
            continue
        e = session_errors(np.stack(s["preds"]), np.stack(s["gt"]), model_pts)
        add += e["add"]
        motion += e["motion"]
    nums = {"pose_add_mm": 1e3 * max(add), "motion_add_mm": 1e3 * max(motion),
            "fail_frames": float(fails)}
    return [{"name": k, "value": v, "limit": float(limits[k])} for k, v in nums.items()
            if k in limits]
