"""Hash-grid encoder of the PyTorch port against the JAX package: level
geometry, the cell and exact layouts' forward values, their custom
backwards' dx and flat table gradient (``jax.grad`` of the same loss), and
the backward differentiated once more (an eikonal-style loss on the
coordinate cotangent), on the same numpy inputs."""
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
    # one dense level (R=8) and one hashed (R=64, table of 2^12 entries)
    "mix": (2, 2, 8, 64, 12),
}


def _specs(name, big_dtype="float32", scatter="xla", layout="cell"):
    args = SPECS[name]
    js = jhg.HashGridSpec(*args, layout=layout, scatter=scatter,
                          big_dtype=big_dtype, reduce="conv")
    ts = thg.HashGridSpec(*args, layout=layout, scatter=scatter,
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
    # seg (the JAX segment-dedup scatter) runs as in JAX
    assert thg.resolve_scatter("seg") == "seg"
    with pytest.raises(ValueError):
        thg.resolve_scatter("bogus")
    assert thg.resolve_reduce("auto", "cpu") == "conv"
    assert thg.resolve_reduce("auto", "cuda") == "pallas"
    assert thg.resolve_reduce("auto") == "pallas"  # None means CUDA
    assert thg.resolve_reduce("conv", "cuda") == "conv"


@pytest.mark.parametrize("name", ["hashed", "dense"])
def test_exact_layout_matches_jax(name):
    """hash_encode (the exact layout) against the JAX hash_encode on dense
    and hashed levels and clipped points: forward within 1e-6 of the
    largest value (same contraction order), dx and the flat table gradient
    within 1e-6 of their largest (one flat scatter-add in another order);
    clipped coordinates get no gradient."""
    js, ts = _specs(name, layout="exact")
    table, x, g = _inputs(js, seed=3)
    ref = np.asarray(jhg.encode(jnp.asarray(x), jnp.asarray(table), js))
    out = thg.encode(torch.from_numpy(x), torch.from_numpy(table), ts)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    jgx, jgt = _grads_jax(js, table, x, g)
    tgx, tgt = _grads_port(ts, table, x, g)
    assert tgt.shape == jgt.shape and tgt.dtype == np.float32
    for a, b in ((tgx, jgx), (tgt, jgt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    assert np.all(tgx[np.abs(x) > 1.0] == 0.0)


@pytest.mark.parametrize("name", ["hashed", "dense"])
def test_exact_equals_cell(name):
    """The port's two f32 layouts: forward bitwise equal (as
    tests/test_hashgrid.py:95 holds the JAX pair), dx bitwise equal, the
    table gradient within 1e-6 of its largest (summation order)."""
    _, ts = _specs(name)
    table, x, g = _inputs(ts, seed=4)
    a = thg.encode(torch.from_numpy(x), torch.from_numpy(table), ts._replace(layout="exact"))
    b = thg.encode(torch.from_numpy(x), torch.from_numpy(table), ts)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    ex, et = _grads_port(ts._replace(layout="exact"), table, x, g)
    cx, ct = _grads_port(ts, table, x, g)
    np.testing.assert_array_equal(ex, cx)
    np.testing.assert_allclose(et, ct, rtol=0, atol=1e-6 * np.abs(ct).max())


def _eikonal_jax(js, table, x, g):
    def loss(t, xx):
        n = jax.grad(lambda p: jnp.sum(jhg.encode(p, t, js) * g))(xx)
        return jnp.sum((jnp.linalg.norm(n, axis=-1) - 1.0) ** 2)

    gt, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(table), jnp.asarray(x))
    return np.asarray(gt, np.float32), np.asarray(gx)


def _eikonal_port(ts, table, x, g):
    tt = torch.tensor(table, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = (thg.encode(xt, tt, ts) * torch.from_numpy(g)).sum()
    n, = torch.autograd.grad(out, xt, create_graph=True)
    ((torch.linalg.norm(n, dim=-1) - 1.0) ** 2).sum().backward()
    return tt.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("name,big,layout,rel", [
    ("mix", "float32", "exact", 1e-5),
    ("mix", "float32", "cell", 1e-5),
    ("dense", "float32", "cell", 1e-5),
    # bf16-staged rows: their cotangent is rounded to bf16 in both
    ("bf16", "bfloat16", "cell", 2.5 / 256),
])
def test_backward_differentiates_again_like_jax(name, big, layout, rel):
    """An eikonal-style loss on the coordinate cotangent, differentiated
    with respect to the table and the points: against JAX's grad of grad
    (which differentiates through both custom VJPs).  The table gradient
    reaches the table only through the rows the backward reads, so a
    backward that used rows saved without a graph would give zero."""
    js, ts = _specs(name, big, layout=layout)
    table, x, g = _inputs(js, n=128, seed=5, lo=-0.99, hi=0.99)
    jt, jx = _eikonal_jax(js, table, x, g)
    tt, tx = _eikonal_port(ts, table, x, g)
    assert np.abs(jt).max() > 0 and np.abs(tt).max() > 0
    for a, b in ((tt, jt), (tx, jx)):
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())
