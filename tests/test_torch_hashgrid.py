"""Hash-grid encoder of the PyTorch port against the JAX package: level
geometry, cell-layout forward values, and the custom backward's dx and flat
table gradient (``jax.grad`` of the same loss), on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import hashgrid as jhg
from bundlesdf_tpu_torch.ops import hashgrid as thg

torch.set_num_threads(2)

# (num_levels, level_dim, base_res, finest_res, log2_hashmap_size)
SPECS = {
    # levels 2-3 hashed (table of 2^15 entries): element path
    "hashed": (4, 2, 16, 128, 15),
    # two dense levels; R=64 reaches 2^18 cells and is bf16-staged
    "bf16": (2, 2, 16, 64, 22),
    # four dense f32 levels (big_dtype float32)
    "dense": (3, 2, 8, 32, 22),
}


def _specs(name, big_dtype="float32", scatter="xla"):
    args = SPECS[name]
    js = jhg.HashGridSpec(*args, layout="cell", scatter=scatter,
                          big_dtype=big_dtype, reduce="conv")
    ts = thg.HashGridSpec(*args, layout="cell", scatter=scatter,
                          big_dtype=big_dtype, reduce="conv")
    return js, ts


def _inputs(spec, n=256, seed=0, lo=-1.05, hi=1.05):
    rng = np.random.default_rng(seed)
    table = (rng.uniform(-1, 1, spec.total_entries * spec.level_dim)
             * 0.1).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)  # some clamped
    g = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return table, x, g


@pytest.mark.parametrize("args", [
    (4, 2, 16, 128, 22), (4, 2, 16, 128, 15), (16, 2, 16, 2048, 19),
    (1, 2, 8, 8, 22), (3, 4, 8, 32, 12),
])
def test_level_params_equal(args):
    js = jhg.HashGridSpec(*args)
    ts = thg.HashGridSpec(*args)
    assert ts.level_params() == js.level_params()
    assert ts.total_entries == js.total_entries
    assert ts.out_dim == js.out_dim
    assert ts.per_level_scale == js.per_level_scale


def test_online_budget_geometry():
    """The online budget: 4 dense levels R = 16..128, 2,462,192 entries;
    R=64 and R=128 are bf16-staged."""
    spec = thg.HashGridSpec(4, 2, 16, 128, 22, layout="cell",
                            big_dtype="bfloat16")
    lp = spec.level_params()
    assert [p["res"] for p in lp] == [16, 32, 64, 128]
    assert all(p["dense"] for p in lp)
    assert spec.total_entries == 2_462_192
    assert [thg._lvl_dtype(spec, p) for p in lp] == [
        torch.float32, torch.float32, torch.bfloat16, torch.bfloat16]


def test_init_table():
    spec = thg.HashGridSpec(2, 2, 16, 32, 22)
    t = thg.init_table(spec, torch.Generator().manual_seed(0), device="cpu")
    assert t.shape == (spec.total_entries * 2,) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4


@pytest.mark.parametrize("name,big", [("hashed", "float32"), ("bf16", "bfloat16"),
                                      ("dense", "float32")])
def test_forward_matches_jax(name, big):
    js, ts = _specs(name, big)
    table, x, _ = _inputs(js)
    ref = np.asarray(jhg.encode(jnp.asarray(x), jnp.asarray(table), js))
    out = thg.encode(torch.from_numpy(x), torch.from_numpy(table), ts)
    assert out.shape == ref.shape and out.dtype == torch.float32
    # same f32 contraction order (bf16 staging rounds the same values)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def _grads_jax(js, table, x, g):
    def loss(xx, t):
        return jnp.sum(jhg.encode(xx, t, js) * g)

    gx, gt = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    return np.asarray(gx), np.asarray(gt, np.float32)


def _grads_port(ts, table, x, g):
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    (thg.encode(xt, tt, ts) * torch.from_numpy(g)).sum().backward()
    return xt.grad.numpy(), tt.grad.numpy()


@pytest.mark.parametrize("name,big,scatter,rel", [
    # f32 levels: same math, scatter-add order only (test_hashgrid.py:240)
    ("hashed", "float32", "xla", 1e-6),
    ("dense", "float32", "xla", 1e-6),
    # the fused small-level scatter (JAX: Pallas kernel, interpreted)
    ("hashed", "float32", "pallas", 1e-6),
    # bf16 grad cache: bf16 scatter-adds in another order (test_hashgrid.py:450)
    ("bf16", "bfloat16", "xla", 2.5 / 256),
])
def test_grads_match_jax(name, big, scatter, rel):
    js, ts = _specs(name, big, scatter)
    table, x, g = _inputs(js, seed=1)
    jgx, jgt = _grads_jax(js, table, x, g)
    tgx, tgt = _grads_port(ts, table, x, g)
    assert tgt.shape == jgt.shape and tgt.dtype == np.float32
    for a, b in ((tgx, jgx), (tgt, jgt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())
    # clamped coordinates get no gradient
    outside = np.abs(x) > 1.0
    assert np.all(tgx[outside] == 0.0)


def test_bf16_reduce_through_kernel_wrapper_matches_plain():
    """reduce="pallas" (the CUDA kernel's wrapper, plain on a CPU tensor)
    gives the same table gradient as reduce="conv"."""
    _, ts = _specs("bf16", "bfloat16")
    table, x, g = _inputs(ts, seed=2)
    a = _grads_port(ts, table, x, g)
    b = _grads_port(ts._replace(reduce="pallas"), table, x, g)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_resolve_knobs():
    assert thg.resolve_scatter("auto") == "xla"
    assert thg.resolve_scatter("xla") == "xla"
    assert thg.resolve_scatter("pallas") == "pallas"
    with pytest.raises(NotImplementedError, match="seg"):
        thg.resolve_scatter("seg")
    with pytest.raises(ValueError):
        thg.resolve_scatter("bogus")
    assert thg.resolve_reduce("auto", "cpu") == "conv"
    assert thg.resolve_reduce("auto", "cuda") == "pallas"
    assert thg.resolve_reduce("auto") == "pallas"  # None means CUDA
    assert thg.resolve_reduce("conv", "cuda") == "conv"


def test_exact_layout_not_ported():
    spec = thg.HashGridSpec(2, 2, 16, 32, 22)  # layout "exact"
    with pytest.raises(NotImplementedError, match="exact"):
        thg.encode(torch.zeros((4, 3)), torch.zeros(spec.total_entries * 2), spec)
