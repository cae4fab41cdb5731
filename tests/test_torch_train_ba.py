"""The port's NofRunner.train_ba and render_frame against the JAX runner's,
from the same weights: the setup of tests/test_nof.py:312-341 (a duplicated
view whose camera pose is perturbed, pulled back by the pose array), and a
rendered frame with the jitter of the JAX runner's PRNGKey(0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_sphere_dataset
from test_nof import tiny_cfg
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch.config import Cfg
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import render as trender
from bundlesdf_tpu_torch.nof import runner as trunner

torch.set_num_threads(2)


def _pair(images, depths, masks, poses, K, cloud, cfg):
    J = jrunner.NofRunner(cfg, images, depths, masks, poses, K, cloud)
    params = tnof.params_from_jax(jax.tree_util.tree_map(np.asarray, J.params),
                                  device="cpu")
    T = trunner.NofRunner(Cfg.wrap(dict(cfg)), images, depths, masks, poses, K, cloud,
                          device="cpu", params=params)
    return J, T


@pytest.fixture(scope="module")
def ba_setup():
    data = make_sphere_dataset(n_views=2, H=32, W=32)
    images = np.stack([data["images"][0]] * 2)
    depths = np.stack([data["depths"][0]] * 2)
    masks = np.stack([data["masks"][0]] * 2)
    poses = np.stack([data["poses"][0]] * 2)
    J, T = _pair(images, depths, masks, poses, data["K"], data["cloud"], tiny_cfg())
    # perturb frame 1's camera pose: 3 deg about z and a translation
    th = np.deg2rad(3.0)
    dT = np.eye(4, dtype=np.float32)
    dT[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    dT[:3, 3] = [0.01, -0.008, 0.005]
    for R in (J, T):
        R.c2w_np[1] = dT @ R.c2w_np[1]
    vs, us = np.where((masks[0] > 0) & (depths[0] > 0.1) & (depths[0] < 2.0))
    return J, T, vs, us


@pytest.mark.parametrize("n_match", [256, 200])
def test_train_ba_matches_jax(ba_setup, n_match):
    """150 steps of f32 Adam (eps 1e-15, lr 5e-3) on both sides, from equal
    weights.  Both sums run in another f32 order, and Adam divides each
    gradient by its own running scale, so the noise does not shrink with
    the gradient: the loss falls ~170x and its relative difference grows
    as it does.  Tolerances: the first 50 losses within rtol 1e-4
    (measured 4e-5), all 150 within 1e-3 of the first loss (measured
    3.2e-4), the pose array within atol 1e-3 (measured 2.0e-4).  200
    matches exercise the JAX runner's power-of-two padding, which the port
    does not need."""
    J, T, vs, us = ba_setup
    pose0 = np.zeros_like(np.asarray(J.params["pose_array"]))
    J.params["pose_array"] = jnp.asarray(pose0)
    with torch.no_grad():
        T.params["pose_array"].zero_()
    sel = np.random.default_rng(n_match).choice(len(vs), size=n_match, replace=False)
    m = np.stack([us[sel], vs[sel], us[sel], vs[sel]], axis=-1).astype(np.float32)
    jh = J.train_ba({(0, 1): m}, n_steps=150, lr=5e-3)
    th = T.train_ba({(0, 1): m}, n_steps=150, lr=5e-3)
    assert len(th) == len(jh) == 150
    jh = np.asarray(jh, np.float64)
    np.testing.assert_allclose(th[:50], jh[:50], rtol=1e-4)
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-3 * jh[0])
    assert th[-1] < 0.5 * th[0]
    pose = T.params["pose_array"].detach().numpy()
    np.testing.assert_allclose(pose, np.asarray(J.params["pose_array"]), rtol=0, atol=1e-3)
    # frame 0 stays pinned, frame 1 got a non-trivial correction; the
    # optimizer still holds the pose tensor that train_ba updated in place
    Ts = tnof.pose_array_matrices(T.params["pose_array"].detach(), T.spec,
                                  torch.arange(2)).numpy()
    np.testing.assert_allclose(Ts[0], np.eye(4), atol=1e-6)
    assert np.abs(Ts[1] - np.eye(4)).max() > 1e-3
    assert any(p is T.params["pose_array"] for g in T.optimizer.groups
               for p in g["params"])


def test_train_ba_without_matches(ba_setup):
    J, T, _, _ = ba_setup
    empty = {(0, 1): np.zeros((0, 4), np.float32)}
    assert T.train_ba(empty) == [] == J.train_ba(empty)


def _render_draws(n, rcfg):
    """The jitter the JAX render_frame draws from PRNGKey(0)
    (render_rays -> sample_z_vals key splits)."""
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    k1, k2, k3 = jax.random.split(key, 3)
    return trender.SampleDraws(*(torch.from_numpy(np.array(jax.random.uniform(k, (n, s))))
                                 for k, s in ((k1, rcfg.n_samples),
                                              (k2, rcfg.n_samples_around_depth),
                                              (k3, rcfg.n_samples_around_depth))))


@pytest.fixture(scope="module")
def render_pair():
    """Equal weights on both sides, trained 5 steps on the JAX side first."""
    data = make_sphere_dataset(n_views=3, H=32, W=32)
    cfg = tiny_cfg()
    cfg["N_rand"] = 128
    J = jrunner.NofRunner(cfg, data["images"], data["depths"], data["masks"],
                          data["poses"], data["K"], data["cloud"])
    J.train(5)
    params = tnof.params_from_jax(jax.tree_util.tree_map(np.asarray, J.params), device="cpu")
    T = trunner.NofRunner(Cfg.wrap(dict(cfg)), data["images"], data["depths"], data["masks"],
                          data["poses"], data["K"], data["cloud"], device="cpu",
                          params=params)
    return J, T


def test_render_frame_matches_jax(render_pair):
    """A rendered frame with the jitter of PRNGKey(0): RGB within 1e-5."""
    J, T = render_pair
    stride = 3
    want = J.render_frame(1, stride=stride)
    n = len(range(0, 32, stride)) ** 2
    got = T.render_frame(1, stride=stride, draws=_render_draws(n, T.rcfg))
    assert got.shape == want.shape == (len(range(0, 32, stride)),) * 2 + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.std() > 1e-3
    # without draws it renders from the runner's generator
    assert T.render_frame(1, stride=stride).shape == want.shape
