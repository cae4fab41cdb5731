"""The port's LoFTR trainer (``bundlesdf_tpu_torch/models/loftr_train.py``)
against the JAX package's (``bundlesdf_tpu/models/loftr_train.py``).

The generators get the uniforms and normals that the JAX functions draw
from their keys (``jax_pair_draws`` follows the JAX key splits).  The
trainer runs the narrow LoFTR of tests/test_torch_loftr.py on 64 x 64
pairs; tests/test_torch_loftr_train_step.py holds three of its steps to the
JAX trainer's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bundlesdf_tpu.models import loftr_jax as lj
from bundlesdf_tpu.models import loftr_train as jlt
from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.models import loftr_train as tlt

torch.set_num_threads(2)

# the narrow LoFTR of tests/test_torch_loftr.py
NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4,
              thr=0.0, max_matches=48)
CFG_T, CFG_J = lt.LoftrCfg(**NARROW), lj.LoftrCfg(**NARROW)
H = W = 64
TCFG = dict(H=H, W=W, batch=2, max_gt=32, lr=1e-3, warmup=2)


def U(k, shape=()):
    return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


def N(k, shape):
    return torch.from_numpy(np.array(jax.random.normal(k, shape)))


def _close(out, ref, rel, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (what, err)


def texture_draws(key, H, W):
    """random_texture(key): its three grids."""
    return [U(k, (H // s, W // s)) for k, s in zip(jax.random.split(key, 3), (8, 4, 2))]


def dots_draws(key, n=96):
    kc, kr, kv, kb = jax.random.split(key, 4)
    return U(kc, (n, 2)), U(kr, (n,)), U(kv, (n,)), U(kb, (4, 4))


def mask_draws(key):
    kc, kr, ka = jax.random.split(key, 3)
    return U(kc, (2,)), U(kr, (2,)), U(ka)


def hom_draws(key):
    ka, ks, kt, kp = jax.random.split(key, 4)
    return U(ka), U(ks), U(kt, (2,)), U(kp, (2,))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _pair_draws(key, batch, H, W):
    u = jax.random.uniform

    def one(k):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        ksel, ka, kb = jax.random.split(k1, 3)
        km, ke = jax.random.split(k5)
        kg, kc, kn = jax.random.split(k3, 3)
        kd = jax.random.split(kb, 4)
        kmask = jax.random.split(ke, 3)
        kh = jax.random.split(k2, 4)
        return (u(ksel), tuple(u(k, (H // s, W // s))
                               for k, s in zip(jax.random.split(ka, 3), (8, 4, 2))),
                (u(kd[0], (96, 2)), u(kd[1], (96,)), u(kd[2], (96,)), u(kd[3], (4, 4))),
                u(km), (u(kmask[0], (2,)), u(kmask[1], (2,)), u(kmask[2])),
                (u(kh[0]), u(kh[1]), u(kh[2], (2,)), u(kh[3], (2,))), u(kg), u(kc),
                jax.random.normal(kn, (H, W)), jax.random.normal(k4, (H, W)))

    return jax.vmap(one)(jax.random.split(key, batch))


def jax_pair_draws(key, batch, H, W) -> tlt.PairDraws:
    """What jax make_batch(key, ...) draws (its key splits), as the port's
    PairDraws."""
    return tlt.PairDraws(*jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), _pair_draws(key, batch, H, W)))


jax_make_batch = jax.jit(jlt.make_batch, static_argnums=(1, 2, 3, 4))


def test_resize_matches_jax_image_resize():
    """The textures' upsampling (grids of 1/8, 1/4, 1/2 and 4 x 4 to the
    pair size) equals jax.image.resize's "linear" within 1 f32 ulp."""
    rng = np.random.default_rng(0)
    for h, w, HH, WW in ((20, 20, 160, 160), (40, 40, 160, 160), (80, 80, 160, 160),
                         (4, 4, 160, 160), (8, 8, 64, 64), (4, 4, 64, 64)):
        x = rng.uniform(size=(h, w)).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (HH, WW), "linear"))
        out = tlt._resize_linear(torch.from_numpy(x), HH, WW).numpy()
        assert np.abs(out - ref).max() <= 2 ** -23


def test_generators_match_jax():
    """Each generator given the JAX key's draws: textures, mask and warp
    within 1e-5 (f32 order: the dots' sums, the 3 x 3 inverse), the
    homography within 1e-6 of its largest entry."""
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)

    def J(fn):
        return jax.jit(fn, static_argnums=(1, 2))

    _close(tlt.random_texture(H, W, texture_draws(k1, H, W)),
           J(jlt.random_texture)(k1, H, W), 1e-5, "texture")
    _close(tlt.random_dots_texture(H, W, 96, *dots_draws(k2)),
           J(jlt.random_dots_texture)(k2, H, W), 1e-5, "dots")
    mixed = J(jlt.mixed_texture)
    for k in jax.random.split(k3, 4):  # both branches of the select
        ksel, ka, kb = jax.random.split(k, 3)
        _close(tlt.mixed_texture(H, W, U(ksel), texture_draws(ka, H, W), dots_draws(kb)),
               mixed(k, H, W), 1e-5, "mixed")
    _close(tlt.random_object_mask(H, W, *mask_draws(k4)),
           J(jlt.random_object_mask)(k4, H, W), 1e-5, "mask")
    Hj = J(jlt.random_homography)(k5, H, W)
    Ht = tlt.random_homography(H, W, *hom_draws(k5))
    _close(Ht, Hj, 1e-6, "homography")
    img = J(jlt.random_texture)(k1, H, W)
    _close(tlt.warp_image(torch.from_numpy(np.array(img)), Ht),
           jax.jit(jlt.warp_image)(img, Hj), 1e-5, "warp")


def test_make_batch_matches_jax():
    """make_batch given jax make_batch's draws: images within 1e-5, GT cells
    and validity equal, GT pixels within 1e-5 of the largest."""
    key = jax.random.PRNGKey(2)
    ref = jax_make_batch(key, 3, H, W, 32)
    out = tlt.make_batch(3, H, W, 32, jax_pair_draws(key, 3, H, W))
    _close(out.img0, np.moveaxis(np.asarray(ref.img0), -1, 1), 1e-5, "img0")
    _close(out.img1, np.moveaxis(np.asarray(ref.img1), -1, 1), 1e-5, "img1")
    for f in ("i_ids", "j_ids", "pos_mask"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    _close(out.pts1, ref.pts1, 1e-5, "pts1")
    assert out.pos_mask.any() and not out.pos_mask.all()


def test_depth_batch_matches_jax():
    """The depth-view pool (host numpy, same seed) equal to the JAX one, and
    make_depth_batch given the JAX key's draws: images within 1e-5, GT
    cells and validity equal, GT pixels within 1e-4 of the largest (a 4 x 4
    inverse and a projection in another f32 order)."""
    jp = jlt.build_depth_view_pool(n_objects=2, views_per=3, H=H, W=W, seed=3)
    tp = tlt.build_depth_view_pool(n_objects=2, views_per=3, H=H, W=W, seed=3, device="cpu")
    for a, b in zip(tp[:4], jp[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda k: jlt.make_depth_batch(k, jp, 3, H, W, 32))(key)
    items = []
    for k in jax.random.split(key, 3):
        ko, kv, kj, kn0, kn1 = jax.random.split(k, 5)
        kb, kc = jax.random.split(kj)
        items.append((torch.tensor(int(jax.random.randint(ko, (), 0, 2))),
                      torch.from_numpy(np.array(jax.random.choice(kv, 3, (2,), replace=False))).long(),
                      U(kb), U(kc), N(kn0, (H, W)), N(kn1, (H, W))))
    draws = tlt.DepthDraws(*(torch.stack(f) for f in zip(*items)))
    out = tlt.make_depth_batch(tp, 3, H, W, 32, draws)
    _close(out.img0, np.moveaxis(np.asarray(ref.img0), -1, 1), 1e-5, "img0")
    _close(out.img1, np.moveaxis(np.asarray(ref.img1), -1, 1), 1e-5, "img1")
    for f in ("i_ids", "j_ids", "pos_mask"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    _close(out.pts1, ref.pts1, 1e-4, "pts1")
    assert out.pos_mask.any()


def test_losses_match_jax():
    """coarse_focal_loss and fine_l2_loss: values (rtol 1e-6) and gradients
    (within 1e-6 of the largest) against the JAX losses."""
    rng = np.random.default_rng(5)
    B, L, K = 2, 16, 6
    conf = rng.uniform(0, 1, (B, L, L)).astype(np.float32)
    conf[0, 0, 0], conf[1, 2, 3] = 0.0, 1.0  # the clip's ends
    i_ids = np.stack([rng.permutation(L)[:K] for _ in range(B)]).astype(np.int32)
    j_ids = rng.integers(0, L, (B, K)).astype(np.int32)
    pos = rng.uniform(size=(B, K)) > 0.3
    mk = rng.normal(0, 20, (B, K, 2)).astype(np.float32)
    gt = rng.normal(0, 20, (B, K, 2)).astype(np.float32)
    jc, jgc = jax.jit(jax.value_and_grad(jlt.coarse_focal_loss))(
        jnp.asarray(conf), jnp.asarray(i_ids), jnp.asarray(j_ids), jnp.asarray(pos))
    jf, jgf = jax.jit(jax.value_and_grad(jlt.fine_l2_loss))(jnp.asarray(mk), jnp.asarray(gt),
                                                   jnp.asarray(pos))
    tc_in = torch.tensor(conf, requires_grad=True)
    tm_in = torch.tensor(mk, requires_grad=True)
    tc = tlt.coarse_focal_loss(tc_in, torch.from_numpy(i_ids).long(),
                               torch.from_numpy(j_ids).long(), torch.from_numpy(pos))
    tf = tlt.fine_l2_loss(tm_in, torch.from_numpy(gt), torch.from_numpy(pos))
    (tc + tf).backward()
    np.testing.assert_allclose(float(tc.detach()), float(jc), rtol=1e-6)
    np.testing.assert_allclose(float(tf.detach()), float(jf), rtol=1e-6)
    _close(tc_in.grad, jgc, 1e-6, "d conf")
    _close(tm_in.grad, jgf, 1e-6, "d mkpts")


def test_optimizer_matches_optax():
    """LoftrOptimizer against the JAX trainer's optax chain over 8 updates
    (warmup 3 of 8 steps: lr 0 at the first, the cosine after), with
    gradients that trip the global-norm clip on some steps and not on
    others: parameters within 1e-6 of their largest each step."""
    rng = np.random.default_rng(6)
    p0 = {"a": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    n_steps, tc = 8, tlt.TrainCfg(lr=1e-2, warmup=3)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, tc.lr, tc.warmup, max(n_steps, tc.warmup + 1))))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(jp)
    update = jax.jit(opt.update)
    leaves = [torch.tensor(p0["a"], requires_grad=True), torch.tensor(p0["b"], requires_grad=True)]
    topt = tlt.LoftrOptimizer(leaves, tc, n_steps)
    clipped = []
    for k in range(n_steps):
        scale = 0.05 if k % 2 else 3.0
        g = {"a": (rng.normal(size=(5, 4)) * scale).astype(np.float32),
             "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}
        clipped.append(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())) >= 1)
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        leaves[0].grad, leaves[1].grad = torch.from_numpy(g["a"]), torch.from_numpy(g["b"])
        topt.step()
        for t, name in zip(leaves, ("a", "b")):
            _close(t.detach(), jp[name], 1e-6, f"step {k} {name}")
    assert any(clipped) and not all(clipped)
    assert topt.schedule(0) == 0.0 and topt.count == n_steps


def _train_pair():
    """A seeded reference-layout state dict; the JAX params converted from
    it and the port's module loaded with it."""
    module = lt.init_weights(lt.LoftrModule(CFG_T), seed=1)
    sd = {k: v.numpy().copy() for k, v in module.state_dict().items()}
    return sd, lj.convert_torch_state_dict(sd, CFG_J), lt.load_weights(lt.LoftrModule(CFG_T), sd)


def test_frozen_batch_norm_in_training():
    """module.train() keeps the running statistics: the forward equals the
    eval forward and the statistics do not move; the trainer's leaves are
    every parameter plus the running means and variances, which then get
    gradients."""
    _, _, module = _train_pair()
    a = torch.rand((1, 1, H, W), generator=torch.Generator().manual_seed(0))
    b = torch.rand((1, 1, H, W), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = module.eval()(a, b)["conf_matrix"]
        stats = {k: v.clone() for k, v in module.state_dict().items() if "running" in k}
        out = module.train()(a, b)["conf_matrix"]
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    for k, v in module.state_dict().items():
        if "running" in k:
            np.testing.assert_array_equal(v.numpy(), stats[k].numpy())
    leaves = tlt.trainable(module)
    assert len(leaves) == len(list(module.parameters())) + len(stats)
    module(a, b)["conf_matrix"].sum().backward()
    bn = module.backbone.bn1
    assert bn.running_mean.grad is not None and bn.running_var.grad.abs().sum() > 0


def test_save_load_and_resume(tmp_path):
    """train_loftr's save_path loads through load_checkpoint with the trained
    weights; resume takes that file and a JAX .npz (save_params_npz) and
    starts from its weights exactly; a device mesh raises, naming its
    ROADMAP item."""
    tcfg = tlt.TrainCfg(**TCFG)
    path = str(tmp_path / "w.pth")
    module, hist = tlt.train_loftr(CFG_T, tcfg, n_steps=2, seed=3, log_every=1,
                                   save_path=path, device="cpu")
    assert [h["step"] for h in hist] == [0, 1] and np.isfinite(hist[-1]["loss"])
    m = lt.load_checkpoint(path, CFG_T, device="cpu")
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(m.module.state_dict()[k].numpy(), v.numpy())
    corres, valid = m.predict(np.zeros((1, H, W), np.float32), np.zeros((1, H, W), np.float32))
    assert corres.shape == (1, CFG_T.max_matches, 5)
    again, _ = tlt.train_loftr(CFG_T, tcfg, n_steps=0, resume=path, device="cpu")
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(again.state_dict()[k].numpy(), v.numpy())
    sd, jparams, _ = _train_pair()
    npz = str(tmp_path / "w.npz")
    lj.save_params_npz(jparams, npz)
    from_jax, _ = tlt.train_loftr(CFG_T, tcfg, n_steps=0, resume=npz, device="cpu")
    for k, v in lt.state_dict_from_flax(jparams, CFG_T).items():
        np.testing.assert_array_equal(from_jax.state_dict()[k].numpy(), v.numpy())
    # a mesh is ported (parallel/, tests/test_torch_loftr_dp.py): anything
    # but a parallel.mesh.Mesh is refused
    with pytest.raises(TypeError, match="Mesh"):
        tlt.train_loftr(CFG_T, tcfg, n_steps=1, mesh=object(), device="cpu")


def test_cli_writes_a_checkpoint(tmp_path):
    """``python3 -m bundlesdf_tpu_torch.models.loftr_train --steps 2 --out``
    (in process, full width on 64 x 64 pairs of batch 1, the CPU)."""
    out = str(tmp_path / "cli.pth")
    assert tlt.main(["--steps", "2", "--size", "64", "--batch", "1", "--out", out,
                     "--log_every", "1", "--device", "cpu"]) == 0
    m = lt.load_checkpoint(out, device="cpu")
    assert m.cfg == lt.LoftrCfg()
