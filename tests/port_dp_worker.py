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
    """``nof_dp_steps`` with the table sharded and replicated (or as
    ``inp["shard_tables"]`` lists)."""
    from bundlesdf_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(device="cpu")
    return {f"shard_table={s}": nof_dp_steps(inp, mesh, s)
            for s in inp.get("shard_tables", (True, False))}


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


class Stream:
    """Records another process writes while this one runs: record ``k`` is
    the pickle ``DIR/<k>.pkl``, which the writer moves into place whole
    (:func:`stream_put`).  ``get(k)`` waits for it, at most ``timeout``
    seconds (the writer may have failed)."""

    def __init__(self, folder, timeout: float = 120.0):
        self.folder, self.records, self.timeout = folder, [], timeout

    def get(self, k: int):
        deadline = time.monotonic() + self.timeout
        while len(self.records) <= k:
            path = os.path.join(self.folder, f"{len(self.records):06d}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    self.records.append(pickle.load(f))
            elif time.monotonic() > deadline:
                raise TimeoutError(f"no record {len(self.records)} in {self.folder}")
            else:
                time.sleep(0.02)
        return self.records[k]


def stream_put(folder, k: int, record) -> None:
    """Write record ``k`` of a :class:`Stream` (atomically)."""
    tmp = os.path.join(folder, f"{k:06d}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(record, f)
    os.replace(tmp, os.path.join(folder, f"{k:06d}.pkl"))


class ReplayDraws:
    """The NOF steps' draws of another run, replayed by ray identity: step
    ``k`` takes the rays ``keys`` of record ``k + 1`` of ``stream`` (frame
    and pixel direction bits, as tests/test_torch_pipeline.py's
    ``_ray_keys``) found in the pool of the runner being built on this
    rank, with that record's jitter; a ray missing from the pool takes the
    row at the recorded index.  Record 0 holds the initial weights."""

    def __init__(self, stream: Stream):
        self.stream, self.k, self.misses, self.runner, self._map = stream, 0, 0, None, None

    def __call__(self, step, n_rays):
        import numpy as np
        import torch

        from bundlesdf_tpu_torch.nof import render as nof_render

        jstep, keys, idx, draws = self.stream.get(self.k + 1)
        self.k += 1
        assert jstep == step, (jstep, step)
        pool = self.runner.rays_np
        if self._map is None or self._map[0] is not pool:
            ids = np.ascontiguousarray(pool[:, [0, 1, 8]]).view(np.int32)
            self._map = (pool, {tuple(r): i for i, r in enumerate(ids)})
        rows = self._map[1]
        self.misses += sum(tuple(k) not in rows for k in keys)
        out = [rows.get(tuple(k), min(int(i), n_rays - 1)) for k, i in zip(keys, idx)]
        return torch.tensor(out), nof_render.SampleDraws(
            *(None if u is None else torch.from_numpy(u) for u in draws))


def run_frames(pipe, data, n_frames):
    """tests/test_torch_pipeline.py's ``_run`` without JAX: feed the cube
    frames to ``pipe`` (rank 0) and record the round starts, statuses,
    keyframes, the nerfed set, the poses, the mesh and the steps."""
    import numpy as np

    starts = []
    orig = pipe._nof_round_start

    def counting():
        orig()
        starts.append((pipe.cnt, pipe._nof_steps_left))

    pipe._nof_round_start = counting
    status = [pipe.run(data["colors"][k], data["depths"][k], data["K"], f"{k:04d}",
                       mask=data["masks"][k]).status for k in range(n_frames)]
    nerfed = [f.id for f in pipe.bundler.keyframes if f.nerfed]
    mesh = pipe.on_finish()
    return {"poses": np.stack([pipe.poses_log[f"{k:04d}"] for k in range(n_frames)]),
            "status": status, "starts": starts, "nerfed": nerfed,
            "kfs": [f.id for f in pipe.bundler.keyframes], "steps": pipe.nof.total_step,
            "mesh_vertices": np.asarray(mesh.vertices),
            "first_pose": pipe.bundler.firstframe.pose_in_model}


def task_joint(inp):
    """The online joint loop under ``dp_devices`` = world on the cube:
    every rank builds the pipeline, rank 0 runs the frames and the others
    follow.  ``inp["stream"]``: optional folder of a :class:`Stream` that
    gives the initial weights (a JAX params tree as numpy) and the NOF
    draws to replay (:class:`ReplayDraws`); ``inp["ransac"]``: optional
    RANSAC uniforms by (frame id, shape); ``inp["fail"]``: (rank, NofRunner
    method) that raises on that rank.  Each rank reports the Frames it
    built and its profiler spans."""
    import torch
    import torch.distributed as dist

    from synthetic_cube import make_cube_sequence

    from bundlesdf_tpu_torch import entry
    from bundlesdf_tpu_torch.config import Cfg
    from bundlesdf_tpu_torch.models import nof as nof_model
    from bundlesdf_tpu_torch.nof import runner as nof_runner
    from bundlesdf_tpu_torch.tracking import frame as frame_mod
    from bundlesdf_tpu_torch.utils import profiler

    rank = dist.get_rank()
    built = []
    frame_init = frame_mod.Frame.__init__

    def counting(self, *a, **k):
        built.append(1)
        frame_init(self, *a, **k)

    frame_mod.Frame.__init__ = counting
    stream = Stream(inp["stream"]) if inp.get("stream") else None
    replay = ReplayDraws(stream) if stream else None
    runner_init = nof_runner.NofRunner.__init__

    def binding(self, *a, **k):
        if replay is not None:
            replay.runner = self
        runner_init(self, *a, **k)

    nof_runner.NofRunner.__init__ = binding
    if stream is not None:
        nof_runner.nof_model.init_nof_params = (
            lambda spec, seed=0, device=None: nof_model.params_from_jax(stream.get(0),
                                                                        device=device))
    if inp.get("fail") and inp["fail"][0] == rank:
        from bundlesdf_tpu_torch.parallel import joint

        def boom(self, *a, **k):
            raise RuntimeError(f"injected fault on rank {rank}")

        for cls in (nof_runner.NofRunner, joint.LeadRunner):
            setattr(cls, inp["fail"][1], boom)
    ransac = None
    if inp.get("ransac") is not None:
        table = inp["ransac"]

        def ransac(seed, shape):
            return torch.from_numpy(table[(int(seed), tuple(shape))])

    cfg_nof = Cfg.wrap(dict(inp["nof"], dp_devices=dist.get_world_size()))
    pipe = entry.build_pipeline(Cfg.wrap(inp["track"]), cfg_nof,
                                start_nerf_keyframes=inp["start"], device="cpu",
                                ransac_draws=ransac, nof_draws=replay)
    out = {"lead": pipe.lead, "bundler": pipe.bundler is not None}
    if pipe.lead:
        data = make_cube_sequence(n_frames=inp["n_frames"], deg_per_frame=inp["deg"])
        out.update(run_frames(pipe, data, inp["n_frames"]))
        runner = pipe.nof
    else:
        runner = pipe.follow()
    out.update(frames_built=len(built), spans=sorted(profiler.stats()),
               runner_steps=runner.total_step, n_frames_nof=runner.n_frames,
               table=runner.params["table"].detach().numpy().copy(),
               pose_array=runner.params["pose_array"].detach().numpy().copy(),
               c2w=runner.c2w_np.copy(),
               replayed=None if replay is None else (replay.k, replay.misses))
    return out


def task_run_video(inp):
    """``run_custom.main(inp["argv"])`` under ``BSDF_*``, with the configs
    ``inp["track"]`` and ``inp["nof"]``: rank 0 tracks and writes, the
    others follow.  Each rank returns the files it opened for writing."""
    import builtins

    from bundlesdf_tpu_torch.config import Cfg
    from bundlesdf_tpu_torch.scripts import run_custom

    run_custom.TRACK_CONFIGS["custom"] = lambda: Cfg.wrap(inp["track"])
    run_custom.default_nof_config = lambda: Cfg.wrap(inp["nof"])
    wrote = []
    builtin_open = builtins.open

    def spying(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            wrote.append(str(file))
        return builtin_open(file, mode, *a, **k)

    builtins.open = spying
    try:
        pipe = run_custom.main(inp["argv"])
    finally:
        builtins.open = builtin_open
    return {"lead": pipe.lead, "bundler": pipe.bundler is not None,
            "steps": pipe.nof.total_step, "wrote": wrote}


TASKS = {"ba": task_ba, "nof_step": task_nof_step, "nof_runner": task_nof_runner,
         "multihost": task_multihost, "loftr": task_loftr, "joint": task_joint,
         "run_video": task_run_video}


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
