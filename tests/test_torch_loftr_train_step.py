"""Three steps of the port's LoFTR trainer against three of the JAX
trainer's: the narrow LoFTR of tests/test_torch_loftr.py on 64 x 64
homography pairs (the JAX key's batches handed to the port), one seeded
reference-layout state dict carried to JAX by ``convert_torch_state_dict``,
each side under its optimizer chain.  (In a file of its own: compiling the
JAX step takes ~20 s of CPU.)"""
import jax
import numpy as np
import optax
import torch

from test_torch_loftr_train import (CFG_J, CFG_T, H, TCFG, W, _train_pair, jax_make_batch,
                                    jax_pair_draws)
from bundlesdf_tpu.models import loftr_jax as lj
from bundlesdf_tpu.models import loftr_train as jlt
from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.models import loftr_train as tlt

torch.set_num_threads(2)


def test_three_train_steps_match_jax():
    """Three train steps (lr 0, then the warmup's 5e-4 and 1e-3) on the same
    homography batches from the same weights, against the JAX trainer's
    make_train_step under its optax chain: the losses within rtol 1e-4;
    after the steps every weight, BatchNorm scales, biases and running
    statistics included (the JAX trainer moves them too), within 2e-4
    absolute: Adam moves each entry by ~lr a step, and its update of a
    near-zero gradient takes the sign of that gradient's rounding."""
    tcfg_j, tcfg_t = jlt.TrainCfg(**TCFG), tlt.TrainCfg(**TCFG)
    n_steps = 3
    sd, jparams, module = _train_pair()
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, TCFG["lr"], TCFG["warmup"],
                                           max(n_steps, TCFG["warmup"] + 1))))
    jstate = jopt.init(jparams)
    jstep = jlt.make_train_step(lj.LoftrModule(CFG_J), tcfg_j, jopt)
    module.train()
    topt = tlt.LoftrOptimizer(tlt.trainable(module), tcfg_t, n_steps)
    tstep = tlt.make_train_step(module, tcfg_t, topt)
    for i in range(n_steps):
        key = jax.random.PRNGKey(10 + i)
        jb = jax_make_batch(key, TCFG["batch"], H, W, TCFG["max_gt"])
        tb = tlt.make_batch(TCFG["batch"], H, W, TCFG["max_gt"],
                            jax_pair_draws(key, TCFG["batch"], H, W))
        jparams, jstate, jm = jstep(jparams, jstate, key, i, jb)
        tm = tstep(tb)
        for k in ("loss", "coarse", "fine"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"{i} {k}")
    ref = lt.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams), CFG_T)
    out = module.state_dict()
    moved = 0
    for k, v in ref.items():
        np.testing.assert_allclose(out[k].numpy(), v.numpy(), rtol=0, atol=2e-4, err_msg=k)
        moved += int((v.numpy() != sd[k]).any())
    assert moved == len(ref)  # every leaf, running statistics too, was updated
