"""The port's NOF checkpoints, mirroring tests/test_nof.py:379-400 and
:496-537: the i_weights cadence on both training paths, a bitwise
``full=True`` resume, a weights-only file refusing resume, the resume
config checks, and a JAX-written checkpoint's weights in the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_sphere_dataset
from test_nof import tiny_cfg
from bundlesdf_tpu.models import nof as jnof
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch.config import Cfg
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import runner as trunner

torch.set_num_threads(2)


def _runner(cfg, n_views=2, H=32, W=32, **kw):
    data = make_sphere_dataset(n_views=n_views, H=H, W=W)
    return trunner.NofRunner(Cfg.wrap(dict(cfg)), data["images"], data["depths"],
                             data["masks"], data["poses"], data["K"], data["cloud"],
                             device="cpu", **kw)


def _leaves_equal(a, b):
    for x, y in zip(trunner.param_leaves(a), trunner.param_leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_i_weights_checkpoint_cadence(tmp_path):
    """i_weights 4, chunks of 2: train(6) writes model_latest.pth at step 4,
    which restores (tests/test_nof.py:379-397)."""
    cfg = tiny_cfg()
    cfg.update(N_rand=128, i_weights=4, loop_chunk=2, save_dir=str(tmp_path))
    runner = _runner(cfg)
    runner.train(6)
    ckpt = tmp_path / "model_latest.pth"
    assert ckpt.exists()
    step_before = runner.global_step
    runner.load_weights(str(ckpt))
    assert runner.global_step == 4 and runner.global_step <= step_before
    assert runner.optimizer.count == 4


def test_i_weights_on_the_async_path(tmp_path):
    """train_advance + train_drain (the scheduler's path) write the
    checkpoint at drain time, once per i_weights boundary crossed."""
    cfg = tiny_cfg()
    cfg.update(N_rand=128, i_weights=5, loop_chunk=2, save_dir=str(tmp_path))
    runner = _runner(cfg)
    runner.train_advance(4)
    runner.train_drain()
    assert not (tmp_path / "model_latest.pth").exists()
    runner.train_advance(2)
    runner.train_drain()
    assert (tmp_path / "model_latest.pth").exists() and runner._ckpt_done == 1
    assert trunner.load_checkpoint(str(tmp_path / "model_latest.pth"))["total_step"] == 6


def test_full_checkpoint_resume_bitwise(tmp_path):
    """save_weights(full=True) -> from_checkpoint: the resumed runner's next
    4 steps give parameters bitwise equal to the uninterrupted run's
    (tests/test_nof.py:496-522)."""
    cfg = tiny_cfg()
    cfg.update(N_rand=128, loop_chunk=2)
    runner = _runner(cfg)
    runner.train(4)
    ckpt = str(tmp_path / "full.pth")
    runner.save_weights(ckpt, full=True)
    runner.train(4)

    restored = trunner.NofRunner.from_checkpoint(Cfg.wrap(dict(cfg)), ckpt, device="cpu")
    assert restored.global_step == 4 and restored.optimizer.count == 4
    assert len(restored.rays_np) == len(runner.rays_np)
    np.testing.assert_array_equal(restored.occ_grid.numpy(), runner.occ_grid.numpy())
    restored.train(4)
    _leaves_equal(runner.params, restored.params)


def test_weights_only_checkpoint_rejects_resume(tmp_path):
    cfg = tiny_cfg()
    cfg["N_rand"] = 64
    runner = _runner(cfg, n_views=1, H=16, W=16)
    ckpt = str(tmp_path / "w.pth")
    runner.save_weights(ckpt)
    with pytest.raises(ValueError, match="weights-only"):
        trunner.NofRunner.from_checkpoint(Cfg.wrap(dict(cfg)), ckpt, device="cpu")


@pytest.mark.parametrize("key,value", [("max_kf_pool", 8), ("sc_factor", 1.5),
                                       ("translation", [0.0, 0.1, 0.0])])
def test_resume_checks_the_config(tmp_path, key, value):
    cfg = tiny_cfg()
    cfg["N_rand"] = 64
    runner = _runner(cfg, n_views=1, H=16, W=16)
    ckpt = str(tmp_path / "f.pth")
    runner.save_weights(ckpt, full=True)
    with pytest.raises(ValueError, match=key):
        trunner.NofRunner.from_checkpoint(Cfg.wrap(dict(cfg, **{key: value})), ckpt,
                                          device="cpu")


def test_checkpoint_holds_numpy_only(tmp_path):
    """The file loads without torch tensors (a card is not needed) and has
    the JAX file's top-level keys."""
    cfg = tiny_cfg()
    cfg["N_rand"] = 64
    runner = _runner(cfg, n_views=1, H=16, W=16)
    runner.train(2)
    ckpt = str(tmp_path / "f.pth")
    runner.save_weights(ckpt, full=True)
    d = trunner.load_checkpoint(ckpt)

    def leaves(x):
        if isinstance(x, dict):
            return [v for k in x for v in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for e in x for v in leaves(e)]
        return [x]

    assert not any(torch.is_tensor(v) for v in leaves(d))
    assert set(d) == {"params", "opt_state", "global_step", "total_step", "occ_grid", "c2w",
                      "n_frames", "sc_factor", "translation", "images", "depths", "masks",
                      "occ_masks", "K", "rays", "build_pts", "key"}


def test_jax_checkpoint_params_give_the_same_sdf(tmp_path):
    """A full checkpoint that the JAX runner wrote: the port's
    load_weights takes its params through params_from_jax, and
    nof_sdf agrees with the JAX one (f32, atol 1e-6); its optimizer state is
    not carried over.  The full file resumes through from_checkpoint."""
    data = make_sphere_dataset(n_views=2, H=32, W=32)
    cfg = tiny_cfg()
    cfg.update(N_rand=128, loop_chunk=2)
    J = jrunner.NofRunner(cfg, data["images"], data["depths"], data["masks"],
                          data["poses"], data["K"], data["cloud"])
    J.train(3)
    ckpt = str(tmp_path / "jax.pth")
    J.save_weights(ckpt, full=True)
    pts = np.random.default_rng(0).uniform(-0.6, 0.6, (512, 3)).astype(np.float32)
    want = np.asarray(jnof.nof_sdf(J.params, J.spec, jnp.asarray(pts)))

    T = _runner(cfg)
    T.load_weights(ckpt)
    assert T.global_step == 3 and T.optimizer.count == 0
    # Adam restarts: its moments (allocated at construction) are zero
    assert not any(t.any() for g in T.optimizer.groups
                   for t in g["exp_avg"] + g["exp_avg_sq"])
    np.testing.assert_array_equal(T.c2w_np, J.c2w_np)
    np.testing.assert_array_equal(T.occ_grid.numpy(), np.asarray(J.occ_grid))
    with torch.no_grad():
        got = tnof.nof_sdf(T.params, T.spec, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    R = trunner.NofRunner.from_checkpoint(Cfg.wrap(dict(cfg)), ckpt, device="cpu")
    np.testing.assert_array_equal(R.rays_np, J.rays_np)
    with torch.no_grad():
        got = tnof.nof_sdf(R.params, R.spec, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isfinite(R.train(2)["loss"])
