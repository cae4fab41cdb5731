"""The hash-grid encoder's ``seg`` scatter (``hash_scatter: seg``, the JAX
package's default) in the PyTorch port against the JAX package, on the same
numpy inputs: the run compaction, the ray-structured encode's forward (the
two-stage run gather included) and gradients on dense f32, bf16-staged and
hashed levels, the overflow fallback, and the gather path chosen level by
level at the online and offline geometry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import hashgrid as jhg
from bundlesdf_tpu_torch.ops import hashgrid as thg
from test_torch_hashgrid import _specs

torch.set_num_threads(2)


def _rays(n_rays, S, seed):
    """Points along rays with z-ordered samples (tests/test_hashgrid.py:278)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.1, 0.9, (n_rays, S)), axis=1)
    return (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3).astype(np.float32)


def _table_g(spec, n, seed):
    rng = np.random.default_rng(seed)
    table = (rng.uniform(-1, 1, spec.total_entries * spec.level_dim) * 0.1).astype(np.float32)
    g = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return table, g


def _level_cells(x, R):
    """(N,) int32 cell of every point at a dense level of resolution R."""
    p = {"scale": R - 1.0, "res": R}
    pgs, _ = jhg._level_fracs(jhg._axes01(jnp.asarray(x)), p)
    return np.asarray(jhg._cell_of(pgs, R))


@pytest.mark.parametrize("R,dtype,order", [
    (8, "float32", "rays"), (16, "float32", "rays"), (32, "float32", "rays"),
    (32, "bfloat16", "rays"), (16, "float32", "random"),
])
def test_seg_compact_matches_jax(R, dtype, order):
    """_seg_compact on one level's cells: run ends, slot_valid and fits
    equal; the run sums bitwise equal (the scan pairs terms as
    jax.lax.associative_scan does), in f32 and in bf16.  Randomly ordered
    samples overflow the cap on both sides."""
    n_rays, S = 32, 48
    x = (_rays(n_rays, S, 0) if order == "rays" else
         np.random.default_rng(1).uniform(-0.9, 0.9, (n_rays * S, 3)).astype(np.float32))
    cell = _level_cells(x, R).reshape(n_rays, S)
    d = np.random.default_rng(2).standard_normal((n_rays, S, 16)).astype(np.float32)
    cap = jhg._seg_cap(R, S)
    jr = jax.jit(jhg._seg_compact, static_argnums=2)(
        jnp.asarray(cell), jnp.asarray(d).astype(getattr(jnp, dtype)), cap)
    tr = thg._seg_compact(torch.from_numpy(cell.copy()), torch.from_numpy(d).to(getattr(torch, dtype)),
                          cap)
    assert tr[0].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tr[0].float().numpy(), np.asarray(jr[0].astype(jnp.float32)))
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    assert tr[3].ndim == 0 and bool(tr[3]) == bool(jr[3]) == (order == "rays")


def _grads_jax(js, table, x, g, n_rays):
    def loss(xx, t):
        return jnp.sum(jhg.encode(xx, t, js, n_rays=n_rays) * g)

    # op by op, as test_torch_hashgrid.py's: XLA's fusion under jit rounds
    # the coordinate cotangent otherwise, by up to ~1e-5 of its largest
    gx, gt = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    return np.asarray(gx), np.asarray(gt, np.float32)


def _encode_jax(js, table, x, n_rays):
    """JAX's encode op by op: under jit XLA fuses the trilinear sums and
    rounds them otherwise, eager it evaluates the port's order."""
    return np.asarray(jhg.encode(jnp.asarray(x), jnp.asarray(table), js, n_rays=n_rays))


def _grads_port(ts, table, x, g, n_rays):
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    (thg.encode(xt, tt, ts, n_rays=n_rays) * torch.from_numpy(g)).sum().backward()
    return xt.grad.numpy(), tt.grad.numpy()


@pytest.mark.parametrize("name,big,rel_table", [
    # f32 and hashed levels: f32 run sums, scatter order (test_hashgrid.py:296)
    ("dense", "float32", None),
    ("hashed", "float32", None),
    ("mix", "float32", None),
    # bf16 levels: the compact stream in bf16 (test_hashgrid.py:450)
    ("bf16", "bfloat16", 2.5 / 256),
])
def test_seg_encode_matches_jax(name, big, rel_table):
    """encode(..., n_rays) under seg against JAX's: the forward bitwise,
    dx within 1e-6 of its largest entry, the table gradient within the JAX
    tests' bounds; the port's seg gradient also close to its own xla one."""
    js, ts = _specs(name, big, "seg")
    n_rays, S = 24, 32
    x = _rays(n_rays, S, 3)
    table, g = _table_g(ts, n_rays * S, 4)
    ref = _encode_jax(js, table, x, n_rays)
    out = thg.encode(torch.from_numpy(x), torch.from_numpy(table), ts, n_rays=n_rays)
    np.testing.assert_array_equal(out.numpy(), ref)
    jgx, jgt = _grads_jax(js, table, x, g, n_rays)
    tgx, tgt = _grads_port(ts, table, x, g, n_rays)
    np.testing.assert_allclose(tgx, jgx, rtol=0, atol=1e-6 * np.abs(jgx).max())
    if rel_table is None:
        np.testing.assert_allclose(tgt, jgt, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(tgt, jgt, rtol=0, atol=rel_table * np.abs(jgt).max())
    _, xla_t = _grads_port(ts._replace(scatter="xla"), table, x, g, n_rays)
    np.testing.assert_allclose(tgt, xla_t, rtol=0, atol=(rel_table or 1e-6) * np.abs(xla_t).max())


def test_seg_overflow_equals_xla_and_jax():
    """tests/test_hashgrid.py:303-322's inputs (random order, ~96 runs a
    ray over the cap): fits is false on both sides, so JAX's cond takes the
    direct scatter, and the port's seg gradient is bitwise equal to the
    port's xla one (test_torch_hashgrid.py holds that one to JAX)."""
    n_rays, S = 16, 96
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (n_rays * S, 3)).astype(np.float32)
    ts = thg.HashGridSpec(2, 2, 16, 32, 14, layout="cell", scatter="seg")
    table, g = _table_g(ts, n_rays * S, 5)
    for p in ts.level_params():
        if p["dense"]:
            cell = _level_cells(x, p["res"]).reshape(n_rays, S)
            cap = thg._seg_cap(p["res"], S)
            d = np.ones((n_rays, S, 16), np.float32)
            assert not bool(thg._seg_compact(torch.from_numpy(cell.copy()), torch.from_numpy(d), cap)[3])
            assert not bool(jax.jit(jhg._seg_compact, static_argnums=2)(
                jnp.asarray(cell), jnp.asarray(d), cap)[3])
    sx, st = _grads_port(ts, table, x, g, n_rays)
    xx, xt = _grads_port(ts._replace(scatter="xla"), table, x, g, n_rays)
    np.testing.assert_array_equal(sx, xx)
    np.testing.assert_array_equal(st, xt)


@pytest.mark.parametrize("order", ["rays", "random"])
def test_two_stage_gather_bitwise(order, monkeypatch):
    """_SEG_GATHER_BYTES patched to 0 on both sides, every dense level takes
    the two-stage run gather (the random order through its direct
    fallback): each level's rows bitwise equal to the direct gather's, and
    the encode bitwise equal to the direct encode and to JAX's."""
    monkeypatch.setattr(jhg, "_SEG_GATHER_BYTES", 0)
    monkeypatch.setattr(thg, "_SEG_GATHER_BYTES", 0)
    n_rays, S = 32, 48
    x = (_rays(n_rays, S, 2) if order == "rays" else
         np.random.default_rng(6).uniform(-0.9, 0.9, (n_rays * S, 3)).astype(np.float32))
    args = (3, 2, 8, 32, 14)
    js = jhg.HashGridSpec(*args, layout="cell", scatter="seg")
    ts = thg.HashGridSpec(*args, layout="cell", scatter="seg")
    table, _ = _table_g(ts, 1, 7)
    tt, xt = torch.from_numpy(table), torch.from_numpy(x)
    axes = thg._axes01(xt)
    C = ts.level_dim
    seen = 0
    for p, view in zip(ts.level_params(), thg._level_views(tt, ts)):
        if not p["dense"]:
            continue
        assert thg._seg_gathers(ts, p, n_rays, n_rays * S)
        cache = thg._build_cell_cache(view, p, C)
        two, _, _ = thg._cell_rows_seg(axes, cache, p, C, n_rays, n_rays * S)
        direct, _, _ = thg._cell_rows(axes, cache, p, C)
        assert torch.equal(two, direct)
        seen += 1
    assert seen == 2  # R = 8 and 16; R = 32 is hashed
    out = thg.encode(xt, tt, ts, n_rays=n_rays)
    np.testing.assert_array_equal(out.numpy(), thg.hash_encode_cell(xt, tt, ts).numpy())
    np.testing.assert_array_equal(out.numpy(), _encode_jax(js, table, x, n_rays))


@pytest.mark.parametrize("geometry,n_rays,S,takes", [
    # the online budget: R = 128's bf16 cache is exactly 64 MiB, not more
    ("online", 2048, 192, []),
    # the offline budget's microbatch: R = 148 (103.7 MB) only
    ("offline", 256, 320, [148]),
])
def test_gather_path_per_level_matches_jax(geometry, n_rays, S, takes, monkeypatch):
    """The levels whose forward takes the two-stage run gather under seg:
    the port's choice level by level equals the levels on which JAX's
    encode calls _cell_rows_seg (traced abstractly)."""
    args = {"online": (4, 2, 16, 128, 22), "offline": (16, 2, 16, 256, 22)}[geometry]
    js = jhg.HashGridSpec(*args, layout="cell", scatter="seg", big_dtype="bfloat16")
    ts = thg.HashGridSpec(*args, layout="cell", scatter="seg", big_dtype="bfloat16")
    called = []
    real = jhg._cell_rows_seg

    def spy(axes, cache, p, *a):
        called.append(p["res"])
        return real(axes, cache, p, *a)

    monkeypatch.setattr(jhg, "_cell_rows_seg", spy)
    n = n_rays * S
    jax.eval_shape(lambda x, t: jhg.encode(x, t, js, n_rays=n_rays),
                   jax.ShapeDtypeStruct((n, 3), jnp.float32),
                   jax.ShapeDtypeStruct((js.total_entries * 2,), jnp.float32))
    port = [p["res"] for p in ts.level_params() if thg._seg_gathers(ts, p, n_rays, n)]
    assert port == called == takes
    # no ray structure, no other scatter: no two-stage gather
    assert not any(thg._seg_gathers(ts, p, 0, n) for p in ts.level_params())
    xla = ts._replace(scatter="xla")
    assert not any(thg._seg_gathers(xla, p, n_rays, n) for p in ts.level_params())


def test_seg_branch_choice_reads_no_host_value():
    """The run-cap choice is a 0-d tensor: encode and backward under seg
    on levels with cap < S run with a tensor's bool() and item() blocked."""
    _, ts = _specs("dense", scatter="seg")
    n_rays, S = 16, 40
    x = _rays(n_rays, S, 8)
    table, g = _table_g(ts, n_rays * S, 9)
    assert any(thg._seg_cap(p["res"], S) < S for p in ts.level_params())
    real = torch.Tensor.__bool__, torch.Tensor.item

    def no_read(*_):
        raise AssertionError("a host read of a tensor in the seg path")

    torch.Tensor.__bool__ = torch.Tensor.item = no_read
    try:
        _, gt = _grads_port(ts, table, x, g, n_rays)
    finally:
        torch.Tensor.__bool__, torch.Tensor.item = real
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0


def test_resolve_and_build_take_seg():
    """seg resolves to seg and reaches the spec through entry.build_nof;
    auto stays the index_add_ path."""
    from bundlesdf_tpu_torch import entry

    assert thg.resolve_scatter("seg") == "seg"
    assert thg.resolve_scatter("auto") == "xla"
    spec = entry.build_nof(n_rand=8, n_samples=4, n_around=2, num_levels=2, finest_res=32,
                           log2_hashmap=12, n_march=8, num_frames=2, occ_res=8,
                           hash_scatter="seg", device="cpu")[0]
    assert spec.grid.scatter == "seg"
