"""Data-parallel LoFTR training: the port's trainer step over a 2-rank
gloo group on the CPU (``tests/port_dp_worker.py``) against the JAX
trainer's ``make_train_step(mesh=make_mesh(2))`` (the conftest's virtual
CPU devices), at the narrow width and 64 x 64 pairs of
tests/test_torch_loftr_train_step.py, with a batch of 4 (2 a rank)."""
import os
import sys

import jax
import numpy as np
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec

from test_torch_loftr_train import (CFG_J, CFG_T, H, NARROW, TCFG, W, _train_pair,
                                    jax_make_batch, jax_pair_draws)
from bundlesdf_tpu.models import loftr_jax as lj
from bundlesdf_tpu.models import loftr_train as jlt
from bundlesdf_tpu.parallel import mesh as jmesh
from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.models import loftr_train as tlt

sys.path.insert(0, os.path.dirname(__file__))
from port_dp_worker import start_ranks  # noqa: E402

torch.set_num_threads(2)

DP_TCFG = dict(TCFG, batch=4)


def test_two_rank_steps_match_jax_mesh_step(tmp_path):
    """Three steps on the same batches from the same weights: the 2-rank
    step's losses (the whole batch's, on every rank) within rtol 1e-4 of
    the JAX mesh step's, and every weight after the steps, BatchNorm
    statistics included, within the 2e-4 of the single-rank test; the
    ranks hold equal weights."""
    n_steps = 3
    sd, jparams, _ = _train_pair()
    keys = [jax.random.PRNGKey(20 + i) for i in range(n_steps)]
    batches = [tlt.make_batch(DP_TCFG["batch"], H, W, DP_TCFG["max_gt"],
                              jax_pair_draws(k, DP_TCFG["batch"], H, W)) for k in keys]
    collect = start_ranks("loftr", 2, {
        "cfg": NARROW, "state_dict": sd, "tcfg": DP_TCFG,
        "batches": [tuple(x.numpy() for x in b) for b in batches]}, tmp_path, timeout=150)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, TCFG["lr"], TCFG["warmup"],
                                           max(n_steps, TCFG["warmup"] + 1))))
    mesh = jmesh.make_mesh(2)
    # the weights and optimizer state start replicated on the mesh, where
    # the step leaves them: the mesh step compiles once, not again at step 1
    jparams, jstate = jax.device_put((jparams, jopt.init(jparams)),
                                     NamedSharding(mesh, PartitionSpec()))
    jstep = jlt.make_train_step(lj.LoftrModule(CFG_J), jlt.TrainCfg(**DP_TCFG), jopt,
                                mesh=mesh)
    jms = []
    for i, k in enumerate(keys):
        jb = jax_make_batch(k, DP_TCFG["batch"], H, W, DP_TCFG["max_gt"])
        jparams, jstate, jm = jstep(jparams, jstate, k, i, jb)
        jms.append({n: float(v) for n, v in jm.items()})
    ref = lt.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams), CFG_T)
    ranks = collect()
    for r in ranks:
        for i in range(n_steps):
            for k in ("loss", "coarse", "fine"):
                np.testing.assert_allclose(r["metrics"][i][k], jms[i][k], rtol=1e-4,
                                           err_msg=f"{i} {k}")
        moved = 0
        for k, v in ref.items():
            np.testing.assert_allclose(r["state_dict"][k], v.numpy(), rtol=0, atol=2e-4,
                                       err_msg=k)
            np.testing.assert_array_equal(r["state_dict"][k], ranks[0]["state_dict"][k])
            moved += int((v.numpy() != sd[k]).any())
        assert moved == len(ref)
