"""Plain PyTorch versions of the port's two CUDA kernels against the JAX
package's Pallas kernels (interpret mode on the CPU, as tests/test_hashgrid.py
runs them), and the wrappers' routing by tensor device.

The CUDA kernels themselves are compiled and held against these plain
versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import hashgrid as jhg
from bundlesdf_tpu.ops.hashgrid_pallas import fused_cache_scatter as jax_fused_scatter
from bundlesdf_tpu.ops.reduce_pallas import reduce_cell_cache_grad_pallas
from bundlesdf_tpu_torch.ops import hashgrid as thg
from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

torch.set_num_threads(2)


@pytest.mark.parametrize("R", [8, 64])
def test_reduce_plain_matches_pallas_and_conv(R):
    """reduce_cell_cache_grad_plain == the Pallas plane-sweep kernel
    (interpret) == _reduce_cell_cache_grad_conv, C=2, bf16 input; all sum
    <= 8 bf16 terms in f32 (atol 1e-5 as test_hashgrid.py:468)."""
    C = 2
    spec = jhg.HashGridSpec(1, C, R, R, 22)
    p = spec.level_params()[0]
    assert p["res"] == R
    rng = np.random.default_rng(3)
    dc = rng.standard_normal((R ** 3, 8 * C)).astype(np.float32)
    dc_j = jnp.asarray(dc).astype(jnp.bfloat16)
    conv = np.asarray(jhg._reduce_cell_cache_grad_conv(dc_j, p, C))
    pallas = np.asarray(reduce_cell_cache_grad_pallas(dc_j, R, C, interpret=True))
    pallas = np.pad(pallas, (0, len(conv) - len(pallas)))
    dc_t = torch.from_numpy(dc).to(torch.bfloat16)
    plain = reduce_cuda.reduce_cell_cache_grad_plain(dc_t, R, C, p["size"])
    assert plain.dtype == torch.float32 and plain.shape == conv.shape
    np.testing.assert_allclose(plain.numpy(), pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), conv, rtol=0, atol=1e-5)
    # the wrapper on a CPU tensor is the plain version, and counts no launch
    before = reduce_cuda.launches
    wrapped = reduce_cuda.reduce_cell_cache_grad(dc_t, R, C, p["size"])
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())
    assert reduce_cuda.launches == before


def test_reduce_f32_matches_jax_pad_add():
    """The plain reduce on an f32 cache == the JAX f32 pad-add reduce."""
    spec = jhg.HashGridSpec(1, 2, 16, 16, 22)
    p = spec.level_params()[0]
    R = p["res"]
    dc = np.random.default_rng(4).standard_normal((R ** 3, 16)).astype(np.float32)
    ref = np.asarray(jhg._reduce_cell_cache_grad(jnp.asarray(dc), p, 2))
    out = thg._reduce_cell_cache_grad(torch.from_numpy(dc), p, 2)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("res_list,n", [((16,), 8192), ((8, 16), 4096)])
def test_fused_scatter_plain_matches_pallas(res_list, n):
    """fused_cache_scatter_plain == the Pallas fused scatter (interpret) for
    one and two levels.  Both sum the same f32 updates per row in different
    orders: atol 1e-5 of the largest sum."""
    rng = np.random.default_rng(5)
    rows = [R ** 3 for R in res_list]
    cells = [rng.integers(0, r, n).astype(np.int32) for r in rows]
    upd = [rng.standard_normal((n, 16)).astype(np.float32) for _ in rows]
    ref = jax_fused_scatter([jnp.asarray(c) for c in cells],
                            [jnp.asarray(u) for u in upd], rows)
    before = hashgrid_cuda.launches
    out = hashgrid_cuda.fused_cache_scatter(
        [torch.from_numpy(c) for c in cells], [torch.from_numpy(u) for u in upd],
        rows)
    assert hashgrid_cuda.launches == before
    assert len(out) == len(ref)
    for o, r, nr in zip(out, ref, rows):
        r = np.asarray(r)
        assert o.shape == (nr, 16) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


def test_fused_scatter_plain_matches_cell_cache_scatter():
    rng = np.random.default_rng(6)
    cell = rng.integers(0, 4096, 2048).astype(np.int32)
    upd = rng.standard_normal((2048, 16)).astype(np.float32)
    ref = np.asarray(jhg._cell_cache_scatter(jnp.asarray(cell), jnp.asarray(upd), 4096))
    (out,) = hashgrid_cuda.fused_cache_scatter_plain(
        [torch.from_numpy(cell)], [torch.from_numpy(upd)], [4096])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Arguments are checked before anything is built; a tensor neither on
    the CPU nor on a CUDA device is refused."""
    meta = torch.empty((8 ** 3, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        reduce_cuda.reduce_cell_cache_grad(meta, 8, 2)
    with pytest.raises(ValueError):
        hashgrid_cuda.fused_cache_scatter([], [], [])
    cells = torch.zeros(4, dtype=torch.int32, device="meta")
    rows = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        hashgrid_cuda.fused_cache_scatter([cells], [rows], [64])


def _ray_major_cells(rng, n, n_rows):
    """Seeded run-length model of the train step's ray-major cells: runs of
    one cell, 1 to 40 rows long, of random cells."""
    lengths = rng.integers(1, 41, n)
    cells = rng.integers(0, n_rows, n)
    return np.repeat(cells, lengths)[:n].astype(np.int32)


@pytest.mark.parametrize("res_list", [(16,), (8, 16)])
def test_fused_scatter_plain_matches_pallas_on_ray_major_runs(res_list):
    """The plain scatter == the Pallas fused scatter (interpret) on
    clustered, ray-major indices, for one and two levels; atol 1e-5 of the
    largest sum as above."""
    rng = np.random.default_rng(7)
    n = 4096
    rows = [R ** 3 for R in res_list]
    cells = [_ray_major_cells(rng, n, r) for r in rows]
    assert all((c[1:] == c[:-1]).mean() > 0.8 for c in cells)
    upd = [rng.standard_normal((n, 16)).astype(np.float32) for _ in rows]
    ref = jax_fused_scatter([jnp.asarray(c) for c in cells],
                            [jnp.asarray(u) for u in upd], rows)
    out = hashgrid_cuda.fused_cache_scatter(
        [torch.from_numpy(c) for c in cells], [torch.from_numpy(u) for u in upd],
        rows)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("R", [8, 12])
def test_reduce_plain_matches_pallas_with_aligned_tail(R):
    """The plain reduce with the level's 8-aligned table size == the Pallas
    reduce (interpret) on the S^3*C entries, and zeros in the tail."""
    C = 2
    S3 = (R + 1) ** 3
    size = -(-S3 // 8) * 8
    assert size > S3
    dc = np.random.default_rng(8).standard_normal((R ** 3, 8 * C)).astype(np.float32)
    pallas = np.asarray(reduce_cell_cache_grad_pallas(
        jnp.asarray(dc).astype(jnp.bfloat16), R, C, interpret=True))
    plain = reduce_cuda.reduce_cell_cache_grad(
        torch.from_numpy(dc).to(torch.bfloat16), R, C, size).numpy()
    assert plain.shape == (size * C,) and pallas.shape == (S3 * C,)
    np.testing.assert_allclose(plain[:S3 * C], pallas, rtol=0, atol=1e-5)
    assert not plain[S3 * C:].any()


@pytest.mark.parametrize("R", [8, 16, 32, 64, 128])
def test_reduce_launch_geometry(R):
    """The reduce kernel's grid covers the S^3 outputs exactly (no empty
    tile or x chunk), fits a block's shared memory, and puts at least 2
    blocks on each of 132 SMs at the online levels R = 64 and 128."""
    S = R + 1
    geo = reduce_cuda.launch_geometry(R, 132)
    ty, tz = geo["tile"]
    gx, gy, gz = geo["grid"]
    assert geo["threads"] == ty * tz == 256
    assert geo["smem_bytes"] <= reduce_cuda.MAX_SMEM_BYTES
    assert geo["smem_bytes"] == 3 * (ty + 1) * (tz + 1) * 32
    for tiles, width in ((gx, tz), (gy, ty), (gz, geo["x_chunk"])):
        assert (tiles - 1) * width < S <= tiles * width
    if R >= 64:
        assert gx * gy * gz >= 2 * 132


def test_kernel_argument_checks():
    """The checks the wrappers make before a launch: 16-byte aligned
    pointers, F % 4 == 0 for the scatter, C = 2 for the reduce.  The CPU
    route is the plain version and takes any width."""
    cells = torch.zeros(65, dtype=torch.int32)
    rows = torch.zeros((64, 16))
    acc = torch.zeros(64 * 16)
    hashgrid_cuda.check_kernel_args([cells[:64]], [rows], acc)
    with pytest.raises(ValueError, match="aligned"):
        hashgrid_cuda.check_kernel_args([cells[1:]], [rows], acc)
    with pytest.raises(ValueError, match="aligned"):
        hashgrid_cuda.check_kernel_args([cells[:64]], [rows], acc[1:])
    with pytest.raises(ValueError, match="F % 4"):
        hashgrid_cuda.check_kernel_args([cells[:64]], [torch.zeros((64, 6))], acc)
    (out,) = hashgrid_cuda.fused_cache_scatter([cells[:64]], [torch.ones((64, 6))], [8])
    assert out.shape == (8, 6) and float(out[0, 0]) == 64.0

    d_cache = torch.zeros((8 ** 3 * 16 + 8,), dtype=torch.bfloat16)
    out = torch.zeros(9 ** 3 * 2)
    reduce_cuda.check_kernel_args(d_cache[:8 ** 3 * 16].view(8 ** 3, 16), 8, 2,
                                  9 ** 3, out)
    with pytest.raises(ValueError, match="aligned"):
        reduce_cuda.check_kernel_args(d_cache[4:8 ** 3 * 16 + 4].view(8 ** 3, 16),
                                      8, 2, 9 ** 3, out)
    with pytest.raises(ValueError, match="aligned"):
        reduce_cuda.check_kernel_args(d_cache[:8 ** 3 * 16].view(8 ** 3, 16), 8, 2,
                                      9 ** 3, out[2:])
    with pytest.raises(ValueError, match="C = 2"):
        reduce_cuda.check_kernel_args(torch.zeros((8 ** 3, 32), dtype=torch.bfloat16),
                                      8, 4, 9 ** 3, out)
