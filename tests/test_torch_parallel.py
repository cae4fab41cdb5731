"""The port's parallel layer (``bundlesdf_tpu_torch/parallel/``) against the
JAX one (``bundlesdf_tpu/parallel/``, on the conftest's 8 virtual CPU
devices), as tests/test_parallel.py holds the JAX layer to its single
device: the ranks are real processes of a 2-rank gloo group on the CPU
(``tests/port_dp_worker.py``), each under a time limit."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from bundlesdf_tpu.config import default_nof_config as jax_cfg
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu.parallel import ba_shard as jba_shard
from bundlesdf_tpu.parallel import mesh as jmesh
from bundlesdf_tpu.parallel import nof_shard as jnof_shard
from bundlesdf_tpu.tracking import ba as jba
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.config import Cfg, default_nof_config as port_cfg
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.parallel import mesh as tmesh
from bundlesdf_tpu_torch.pipeline.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.tracking import ba as tba

sys.path.insert(0, os.path.dirname(__file__))
from port_dp_worker import _named, nof_dp_steps, start_ranks  # noqa: E402
from synthetic import make_sphere_dataset  # noqa: E402
from test_parallel import _toy_ba_problem  # noqa: E402
from test_torch_train import _step_draws  # noqa: E402

torch.set_num_threads(2)

# test_parallel.py's dp-step problem with every optional loss term on
SMALL = dict(n_rand=64, n_samples=8, n_around=4, num_levels=2, finest_res=32,
             log2_hashmap=12, n_march=32, num_frames=4, occ_res=16)
OPTIONAL = dict(depth_weight=0.1, fs_rgb_weight=0.2, eikonal_weight=0.05,
                pose_reg_weight=0.01)
STEPS = 2


def _rel_l2(a, b):
    d = np.linalg.norm(np.asarray(a, np.float64) - b)
    return d / np.linalg.norm(b) if d else 0.0


def test_sharded_ba_matches_jax_and_single(tmp_path):
    """The 2-rank sharded BA against the JAX sharded BA on make_mesh(8) and
    the port's single BA, atol 1e-5 (test_parallel.py:86)."""
    p = _toy_ba_problem()
    params = dict(num_iter_outer=5, w_p2p=0.0)
    names = ("poses", "fixed", "ii", "jj", "pi", "pj", "valid", "pair_i", "pair_j",
             "pair_valid", "xyz_ds", "nrm_ds", "ok_ds", "K_ds")
    collect = start_ranks("ba", 2, {"problem": {k: np.asarray(p[k]) for k in names}
                                    | {"n_frames": p["n_frames"]}, "params": params},
                          tmp_path)
    jfn = jba_shard.make_sharded_bundle_adjust(jmesh.make_mesh(8), jba.BAParams(**params),
                                               p["n_frames"])
    jout, _ = jfn(*(jnp.asarray(p[k]) for k in names))
    t = [torch.from_numpy(np.asarray(p[k])) for k in names]
    for i in (2, 3, 7, 8):
        t[i] = t[i].long()
    single, _ = tba.bundle_adjust(*t, tba.BAParams(**params), p["n_frames"])
    ranks = collect()
    for r in ranks:
        np.testing.assert_allclose(r["poses"], np.asarray(jout), atol=1e-5)
        np.testing.assert_allclose(r["poses"], single.numpy(), atol=1e-5)
        np.testing.assert_array_equal(r["poses"], ranks[0]["poses"])
    err0 = np.linalg.norm(p["poses"][1:, :3, 3] - p["gt"][1:, :3, 3])
    err1 = np.linalg.norm(ranks[0]["poses"][1:, :3, 3] - p["gt"][1:, :3, 3])
    assert err1 < err0 * 0.5


def _jax_dp_problem():
    spec, rcfg, weights, jp0, rays, c2w, grid = __graft_entry__._build_nof(**SMALL)
    st = jrunner.TrainStatics(spec=spec, rcfg=rcfg, weights=weights._replace(**OPTIONAL),
                              n_rand=SMALL["n_rand"], n_step=500, trunc=0.01,
                              trunc_start=0.01, trunc_decay_type="", sc_factor=1.0)
    pool = jnp.concatenate([rays, rays[::-1]])
    # pose corrections off zero: the gradient of pose_reg's norm at 0 is
    # NaN in JAX (0 in torch)
    rng = np.random.default_rng(1)
    jp0 = dict(jp0, pose_array=jnp.asarray(
        rng.normal(0.0, 1e-3, jp0["pose_array"].shape).astype(np.float32)))
    return st, jp0, pool, grid, c2w


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_dp_step_matches_jax_dp_step(tmp_path):
    """The 2-rank dp step (table sharded and replicated) against the JAX
    nof_shard.make_dp_train_step on make_mesh(2), every optional loss term
    on, from the same weights with the JAX key's batches and jitter: each
    step's loss and terms within rtol 1e-4 (test_torch_train.py); the first
    step's all-reduced gradients against the JAX gradient of the same
    objective, relative L2 1e-4 a leaf; the weights after the steps as
    test_torch_train.py holds them; sharded and replicated tables equal."""
    st, jp0, pool, grid, c2w = _jax_dp_problem()
    n_rays = int(pool.shape[0])
    key = jax.random.PRNGKey(0)
    draws = [_step_draws(key, i, st, n_rays) for i in range(STEPS)]
    inputs = {"build": SMALL, "weights": OPTIONAL,
              "params": jax.tree_util.tree_map(np.asarray, jp0), "pool": np.asarray(pool),
              "draws": [(idx.numpy(), tuple(None if u is None else u.numpy() for u in d))
                        for idx, d in draws]}
    collect = start_ranks("nof_step", 2, inputs, tmp_path, timeout=150)

    # the step's gradients, as the optimizer chain receives them, kept in
    # the first transform's state
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    opt = optax.chain(keep, jrunner.make_optimizer(jax_cfg()))
    step, place = jnof_shard.make_dp_train_step(st, opt, jmesh.make_mesh(2))
    jp, jo, pool_d, grid_d, c2w_d = place(jp0, opt.init(jp0), pool, grid, c2w)
    jms = []
    for i in range(STEPS):
        jp, jo, m = step(jp, jo, i, key, pool_d, jnp.asarray(n_rays, jnp.int32), grid_d, c2w_d)
        jms.append({k: float(v) for k, v in m.items()})
        if i == 0:
            jg = _flat(jo[0])
    jp, jp0n = _flat(jp), _flat(jp0)
    ranks = collect()

    for run in ("shard_table=True", "shard_table=False"):
        for r in ranks:
            out = r[run]
            for i in range(STEPS):
                assert out["metrics"][i]["valid_rays"] == jms[i]["valid_rays"]
                for k in ("loss", "rgb_loss", "fs_loss", "sdf_loss", "depth_loss",
                          "fs_rgb_loss", "eikonal_loss"):
                    np.testing.assert_allclose(out["metrics"][i][k], jms[i][k], rtol=1e-4,
                                               err_msg=f"{run} step {i} {k}")
            assert set(out["grads"]) == set(jg)
            for k, g in out["grads"].items():
                assert _rel_l2(g, jg[k]) <= 1e-4, (run, k, _rel_l2(g, jg[k]))
            for k, v in out["params"].items():
                # test_torch_train.py's table rule, for every leaf: Adam's eps
                # of 1e-15 turns an entry whose gradient is near zero into a
                # +-lr step whose sign depends on summation order (the
                # eikonal and pose terms leave a few in the MLP weights)
                touched = jp[k] != jp0n[k]
                off = np.abs(v - jp[k]) > 2e-5
                assert touched.sum() > 0 and off.sum() <= 0.01 * touched.sum(), k
                assert np.all(np.abs(v - jp[k]) <= 3 * 0.01 + 1e-6), k
            for k, v in out["params"].items():  # every rank holds the same weights
                np.testing.assert_array_equal(v, ranks[0][run]["params"][k])
    on, off = ranks[0]["shard_table=True"], ranks[0]["shard_table=False"]
    assert on["metrics"] == off["metrics"]
    for k in on["params"]:
        np.testing.assert_array_equal(on["params"][k], off["params"][k], err_msg=k)


def test_dp_step_under_seg_matches_one_rank(tmp_path):
    """The 2-rank dp step under hash_scatter seg (the JAX dp step's
    default), table sharded, against the same steps on a one-rank mesh in
    this process: each rank's segment-dedup scatters see its own rays, and
    the gradients summed over the ranks are the one rank's up to f32
    summation order.  Each step's loss and terms within rtol 1e-4, the
    first step's gradients within relative L2 1e-4 a leaf, the weights
    after the steps as test_dp_step_matches_jax_dp_step holds them, equal
    on both ranks."""
    st, jp0, pool, grid, c2w = _jax_dp_problem()
    n_rays = int(pool.shape[0])
    key = jax.random.PRNGKey(0)
    inputs = {"build": dict(SMALL, hash_scatter="seg"), "weights": OPTIONAL,
              "params": jax.tree_util.tree_map(np.asarray, jp0), "pool": np.asarray(pool),
              "draws": [(idx.numpy(), tuple(None if u is None else u.numpy() for u in d))
                        for idx, d in (_step_draws(key, i, st, n_rays) for i in range(STEPS))],
              "shard_tables": (True,)}
    collect = start_ranks("nof_step", 2, inputs, tmp_path, timeout=150)
    one = nof_dp_steps(inputs, tmesh.make_mesh(1, device="cpu"), True)
    ranks = [r["shard_table=True"] for r in collect()]
    for out in ranks:
        for i in range(STEPS):
            assert out["metrics"][i]["valid_rays"] == one["metrics"][i]["valid_rays"]
            for k in ("loss", "rgb_loss", "fs_loss", "sdf_loss", "eikonal_loss"):
                np.testing.assert_allclose(out["metrics"][i][k], one["metrics"][i][k],
                                           rtol=1e-4, err_msg=f"step {i} {k}")
        assert set(out["grads"]) == set(one["grads"])
        for k, g in out["grads"].items():
            assert _rel_l2(g, one["grads"][k]) <= 1e-4, (k, _rel_l2(g, one["grads"][k]))
        for k, v in out["params"].items():
            ref, start = one["params"][k], _flat(jp0)[k]
            touched = ref != start
            off = np.abs(v - ref) > 2e-5
            assert touched.sum() > 0 and off.sum() <= 0.01 * touched.sum(), k
            assert np.all(np.abs(v - ref) <= 3 * 0.01 + 1e-6), k
            np.testing.assert_array_equal(v, ranks[0]["params"][k])


def _sphere_cfg():
    cfg = port_cfg()
    cfg.update({"N_rand": 128, "N_samples": 16, "N_samples_around_depth": 8,
                "num_levels": 2, "finest_res": 32, "log2_hashmap_size": 14,
                "octree_smallest_voxel_size": 0.05, "octree_dilate_size": 0.05,
                "max_kf_pool": 8, "sc_factor": 1.0, "translation": [0.0] * 3,
                "loop_chunk": 2, "frame_features": 2})
    return cfg


def test_nof_runner_dp_devices_trains(tmp_path):
    """NofRunner(dp_devices=2) (test_parallel.py's runner test, with frame
    features on) trains to global_step 12 on 2 ranks with the table
    sharded; the ranks hold equal weights and agree on the step
    calibration; its losses follow the single-rank runner's (the same
    generator draws, up to f32 summation order); its rank-0 checkpoint loads
    into a single-rank runner; a rank whose frames differ makes
    construction raise on every rank."""
    data = make_sphere_dataset(n_views=3, H=32, W=32)
    cfg = _sphere_cfg()
    ckpt = str(tmp_path / "dp.pth")
    collect = start_ranks("nof_runner", 2, {"data": data, "cfg": dict(cfg), "ckpt": ckpt},
                          tmp_path / "ranks", timeout=150)
    args = (data["images"], data["depths"], data["masks"], data["poses"], data["K"],
            data["cloud"])
    single = trunner.NofRunner(cfg, *args, device="cpu")
    s0, s1 = single.train(4), single.train(8)
    ranks = collect()
    for r in ranks:
        assert r["global_step"] == 12 and np.isfinite(r["m1"]["loss"])
        assert r["shard_len"] == r["table_len"] // 2
        assert r["step_ms"] == ranks[0]["step_ms"] > 0
        assert "different ray pools" in r["mismatch"]
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
    for mine, ref in ((ranks[0]["m0"], s0), (ranks[0]["m1"], s1)):
        assert mine["valid_rays"] == ref["valid_rays"]
        np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=1e-3)
        assert mine["feature_reg"] == pytest.approx(ref["feature_reg"], rel=1e-3)
    resumed = trunner.NofRunner.from_checkpoint(cfg, ckpt, device="cpu")
    assert resumed.global_step == 12 and resumed.mesh is None
    for k, t in _named(resumed.params).items():
        np.testing.assert_array_equal(t.detach().numpy(), ranks[0]["params"][k], err_msg=k)
    state = trunner.load_checkpoint(ckpt)["opt_state"]
    table_pos = list(resumed.params).index("table")
    assert state["adam"][0][table_pos]["exp_avg"].shape == (ranks[0]["table_len"],)
    resumed.train(2)


def test_loss_fn_with_one_rank_is_unchanged_to_the_bit():
    """make_loss_fn over a one-rank mesh (no process group) gives today's
    loss, metrics and gradients bit for bit, with every optional term and
    the frame features on."""
    spec, rcfg, weights, _, rays, c2w, grid = tentry.build_nof(**SMALL, device="cpu")
    spec = spec._replace(frame_features=2)
    st = trunner.TrainStatics(spec, rcfg, weights._replace(**OPTIONAL), SMALL["n_rand"],
                              500, 0.01, 0.01, "", 1.0)
    mesh = tmesh.make_mesh(1, device="cpu")
    assert mesh.size == 1 and mesh.rows(64) == slice(0, 64)
    assert torch.equal(tmesh.shard(mesh, rays), rays)
    assert torch.equal(tmesh.replicated(mesh, rays), rays)
    out = []
    for m in (None, mesh):
        params = tnof.init_nof_params(spec, seed=3, device="cpu")
        loss, metrics = trunner.make_loss_fn(st, m)(
            params, rays, grid, c2w, 0, generator=torch.Generator().manual_seed(5))
        loss.backward()
        out.append((metrics, [p.grad.clone() for p in trunner.param_leaves(params)]))
    (m0, g0), (m1, g1) = out
    assert set(m0) == set(m1) and "feature_reg" in m0 and "eikonal_loss" in m0
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_dp_needs_a_process_group():
    """make_mesh(2) raises without a process group (the JAX Mesh quietly
    shrinks to the devices it has); so does NofRunner(dp_devices=2)."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(2, device="cpu")
    data = make_sphere_dataset(n_views=2, H=16, W=16)
    with pytest.raises(RuntimeError, match="process group"):
        trunner.NofRunner(Cfg.wrap(dict(_sphere_cfg(), dp_devices=2)), data["images"],
                          data["depths"], data["masks"], data["poses"], data["K"],
                          data["cloud"], device="cpu")


def test_online_loop_under_dp_raises_at_construction():
    """BundleSdf(use_nof=True) with dp_devices > 1 and no process group
    raises make_mesh's error when it is built, never a quiet single-rank
    run; the tracking-only pipeline and dp_devices 1 build, and track
    (tests/test_torch_joint_dp.py runs the loop over 2 ranks)."""
    cfg = port_cfg().merged({"dp_devices": 2})
    with pytest.raises(RuntimeError, match="a 2-rank mesh needs a process group"):
        BundleSdf(cfg_nof=cfg, use_nof=True, device="cpu")
    assert BundleSdf(cfg_nof=cfg, use_nof=False, device="cpu").lead
    one = BundleSdf(cfg_nof=port_cfg().merged({"dp_devices": 1}), device="cpu")
    assert one.lead and one.bundler is not None
    with pytest.raises(RuntimeError, match="follow"):
        one.follow()


@pytest.mark.parametrize("n,size", [(64, 2), (5, 4), (3, 4), (10, 3)])
def test_mesh_rows_and_bounds(n, size, monkeypatch):
    """Batch shares cover the rows once, as tensor_split cuts them; shard
    ranges are the ceil(n / size) chunks of the padded collectives."""
    mesh = tmesh.Mesh(tuple(range(size)), "dp", torch.device("cpu"))
    rows, bounds = [], []
    for r in range(size):
        monkeypatch.setattr(tmesh.dist, "get_rank", lambda group=None, r=r: r)
        rows.append(mesh.rows(n))
        bounds.append(mesh.bounds(n))
    ref = [len(t) for t in torch.tensor_split(torch.arange(n), size)]
    assert [s.stop - s.start for s in rows] == ref
    assert rows[0].start == 0 and all(a.stop == b.start for a, b in zip(rows, rows[1:]))
    chunk = -(-n // size)
    assert bounds == [(min(r * chunk, n), min((r + 1) * chunk, n)) for r in range(size)]
