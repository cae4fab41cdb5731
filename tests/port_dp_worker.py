"""Ranks of the port's parallel layer for the CPU tests (imports no JAX).

``run_ranks(task, world, inputs, tmp)`` (or ``start_ranks``, which returns
while they run) starts ``world`` processes of this file, each one rank of a ``gloo`` group on the CPU joined through the
``BSDF_*`` variables (``parallel.distributed.init_multihost``).  Each
reads the pickled ``inputs``, runs ``TASKS[task]`` and pickles its result
to ``tmp/rank<r>.pkl``.  The ranks run under a time limit: one that hangs
or fails fails the calling test, with every rank's output in the message.

    python tests/port_dp_worker.py TASK IN_PKL OUT_DIR    # one rank
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(task: str, world: int, inputs: dict, tmp, local_world: int | None = None,
                timeout: float = 120.0):
    """Start ``task`` on ``world`` ranks (``local_world`` ranks a host) and
    return ``collect() -> [result of rank 0, 1, ...]``, which waits for
    them; the caller may work meanwhile."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    in_pkl = os.path.join(tmp, "inputs.pkl")
    with open(in_pkl, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, BSDF_COORDINATOR=f"localhost:{free_port()}",
               BSDF_NUM_PROCESSES=str(world), PYTHONPATH=ROOT + os.pathsep + HERE,
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    if local_world:
        env["BSDF_LOCAL_WORLD_SIZE"] = str(local_world)
    procs = [subprocess.Popen([sys.executable, __file__, task, in_pkl, tmp],
                              env=dict(env, BSDF_PROCESS_ID=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout

    def collect() -> list:
        logs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                logs.append(f"--- rank {len(logs)} rc {p.returncode}\n{out}\n{err[-4000:]}")
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise AssertionError(f"{task}: ranks did not finish in {timeout} s\n"
                                 + "\n".join(logs))
        if any(p.returncode for p in procs):
            raise AssertionError(f"{task}: a rank failed\n" + "\n".join(logs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    return collect


def run_ranks(task: str, world: int, inputs: dict, tmp, local_world: int | None = None,
              timeout: float = 120.0) -> list:
    """``start_ranks(...)()``: run ``task`` and return each rank's result."""
    return start_ranks(task, world, inputs, tmp, local_world, timeout)()


# ------------------------------------------------------------------ tasks ---

def _np(t):
    return t.detach().cpu().numpy().copy()


def _named(params, prefix=""):
    """``{"sigma/w0": tensor, ...}`` of a nested parameter dict."""
    if isinstance(params, dict):
        return {n: t for k in params for n, t in _named(params[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: params}


def task_ba(inp):
    """The sharded BA over the global mesh: its poses and chi2."""
    import torch

    from bundlesdf_tpu_torch.parallel import ba_shard, distributed
    from bundlesdf_tpu_torch.tracking import ba as ba_mod

    p = inp["problem"]
    mesh = distributed.global_mesh(device="cpu")
    fn = ba_shard.make_sharded_bundle_adjust(mesh, ba_mod.BAParams(**inp["params"]),
                                             p["n_frames"])
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "n_frames"}
    for k in ("ii", "jj", "pair_i", "pair_j"):
        t[k] = t[k].long()
    poses, info = fn(t["poses"], t["fixed"], t["ii"], t["jj"], t["pi"], t["pj"], t["valid"],
                     t["pair_i"], t["pair_j"], t["pair_valid"], t["xyz_ds"], t["nrm_ds"],
                     t["ok_ds"], t["K_ds"])
    return {"poses": _np(poses), "chi2_feature": _np(info["chi2_feature"])}


def nof_dp_steps(inp, mesh, shard_table: bool):
    """``inp["steps"]`` dp NOF steps from ``inp["params"]`` (a JAX params
    tree as numpy) with the given whole-batch draws: each step's metrics,
    the first step's all-reduced gradients (before the clip) and the
    parameters after."""
    import torch

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import default_nof_config
    from bundlesdf_tpu_torch.models import nof as nof_model
    from bundlesdf_tpu_torch.nof import render as nof_render
    from bundlesdf_tpu_torch.nof import runner
    from bundlesdf_tpu_torch.parallel import nof_shard

    spec, rcfg, weights, _, _, c2w, grid = entry.build_nof(**inp["build"], device="cpu")
    weights = weights._replace(**inp.get("weights", {}))
    st = runner.TrainStatics(spec, rcfg, weights, inp["build"]["n_rand"], 500, 0.01, 0.01,
                             "", 1.0)
    params = nof_model.params_from_jax(inp["params"], device="cpu")
    opt = runner.make_optimizer(default_nof_config(), params)
    step, place = nof_shard.make_dp_train_step(st, opt, mesh, shard_table)
    params, pool, grid, c2w = place(params, torch.from_numpy(inp["pool"]), grid, c2w)
    grads = {}
    reduce_grads = opt._reduce_grads

    def capture():
        reduce_grads()
        if not grads:
            for name, t in _named(params).items():
                g = t.grad
                if t is opt.table and opt.shard is not None:
                    g = opt._gather(opt.shard.grad)
                grads[name] = _np(g)

    opt._reduce_grads = capture
    metrics = []
    for i, (idx, draws) in enumerate(inp["draws"]):
        m = step(params, i, pool, pool.shape[0], grid, c2w,
                 batch_idx=torch.from_numpy(idx).long(),
                 draws=nof_render.SampleDraws(*(None if u is None else torch.from_numpy(u)
                                                for u in draws)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": grads,
            "params": {k: _np(v) for k, v in _named(params).items()}}


def task_nof_step(inp):
    """``nof_dp_steps`` with the table sharded and replicated."""
    from bundlesdf_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(device="cpu")
    return {f"shard_table={s}": nof_dp_steps(inp, mesh, s) for s in (True, False)}


def task_nof_runner(inp):
    """``NofRunner(dp_devices=world)`` trains 4 + 8 steps and writes a full
    checkpoint (rank 0); then a runner whose rank-1 frames differ must
    raise at construction."""
    import torch.distributed as dist

    from bundlesdf_tpu_torch.config import Cfg
    from bundlesdf_tpu_torch.nof.runner import NofRunner

    d = inp["data"]
    cfg = Cfg.wrap(dict(inp["cfg"], dp_devices=dist.get_world_size()))
    args = (d["images"], d["depths"], d["masks"], d["poses"], d["K"], d["cloud"])
    runner = NofRunner(cfg, *args, device="cpu")
    m0 = runner.train(4)
    m1 = runner.train(8)
    runner.save_weights(inp["ckpt"], full=True)
    out = {"m0": m0, "m1": m1, "global_step": runner.global_step,
           "table_len": runner.params["table"].numel(),
           "shard_len": runner.optimizer.shard.numel(),
           "params": {k: _np(v) for k, v in _named(runner.params).items()}}
    out["step_ms"] = runner.calibrate_step_ms()    # trains on: after the snapshot
    images = d["images"].copy()
    if dist.get_rank() == 1:
        images[0] += 0.01
    try:
        NofRunner(cfg, images, *args[1:], device="cpu")
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


def task_multihost(inp):
    """The 2-D host layout, an all-reduce over the world and over each
    axis, and one dp NOF step on the global mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bundlesdf_tpu_torch.parallel import distributed

    rank = dist.get_rank()
    x = torch.tensor([float(rank)])
    dist.all_reduce(x)
    hm = distributed.host_by_device_mesh(device="cpu")
    per_axis = {a: float(hm[a].all_reduce(torch.tensor([float(rank)]))[0])
                for a in hm.axis_names}
    step = nof_dp_steps(inp, distributed.global_mesh(device="cpu"), True)
    return {"psum": float(x[0]), "grid": np.asarray(hm.grid),
            "axes": {a: hm[a].ranks for a in hm.axis_names}, "axis_sums": per_axis,
            "loss": step["metrics"][0]["loss"],
            "host": rank // distributed.local_world_size()}


def task_loftr(inp):
    """``inp["n"]`` data-parallel LoFTR steps on the given whole batches:
    metrics and the state dict after."""
    import torch

    from bundlesdf_tpu_torch.models import loftr as lt
    from bundlesdf_tpu_torch.models import loftr_train as tlt
    from bundlesdf_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(device="cpu")
    cfg = lt.LoftrCfg(**inp["cfg"])
    module = lt.load_weights(lt.LoftrModule(cfg), inp["state_dict"]).train()
    tcfg = tlt.TrainCfg(**inp["tcfg"])
    opt = tlt.LoftrOptimizer(tlt.trainable(module), tcfg, len(inp["batches"]))
    step = tlt.make_train_step(module, tcfg, opt, mesh)
    metrics = []
    for b in inp["batches"]:
        m = step(tlt.HomographyBatch(*(torch.from_numpy(x) for x in b)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "state_dict": {k: _np(v) for k, v in module.state_dict().items()}}


TASKS = {"ba": task_ba, "nof_step": task_nof_step, "nof_runner": task_nof_runner,
         "multihost": task_multihost, "loftr": task_loftr}


def main(task: str, in_pkl: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.modules["jax"] = None           # the port's ranks run without JAX
    from bundlesdf_tpu_torch.parallel import distributed

    assert distributed.init_multihost(backend="gloo")
    import torch.distributed as dist

    with open(in_pkl, "rb") as f:
        inp = pickle.load(f)
    out = TASKS[task](inp)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [ROOT, HERE]
    main(*sys.argv[1:4])
