"""The port's multi-process runtime (``parallel/distributed.py``) as
tests/test_multihost.py holds the JAX one: four real processes joined
through the ``BSDF_*`` variables as 2 hosts x 2 ranks
(``BSDF_LOCAL_WORLD_SIZE`` 2) in one gloo group on the CPU
(``tests/port_dp_worker.py``, under a time limit)."""
import os
import sys

import jax
import numpy as np
import torch
import torch.distributed as dist

from bundlesdf_tpu.parallel import distributed as jdist
from bundlesdf_tpu_torch import entry as tentry
from bundlesdf_tpu_torch.models import nof as tnof
from bundlesdf_tpu_torch.parallel import distributed as tdist

sys.path.insert(0, os.path.dirname(__file__))
from port_dp_worker import run_ranks  # noqa: E402

SMALL = dict(n_rand=16, n_samples=8, n_around=4, num_levels=2, finest_res=32,
             log2_hashmap=12, n_march=32, num_frames=4, occ_res=16)


class _FakeDevice:
    def __init__(self, process_index, id):
        self.process_index, self.id = process_index, id


def _jax_host_grid(monkeypatch, n_hosts, per):
    """The JAX host_by_device_mesh's (process_index, id) grid for n_hosts
    processes of ``per`` devices each, listed out of order."""
    devs = [_FakeDevice(h, h * per + i) for h in range(n_hosts) for i in range(per)]
    monkeypatch.setattr(jax, "devices", lambda: devs[::-1])
    monkeypatch.setattr(jax, "process_count", lambda: n_hosts)
    monkeypatch.setattr(jax.sharding, "Mesh", lambda grid, axes: (grid, axes))
    grid, axes = jdist.host_by_device_mesh()
    return [[(d.process_index, d.id) for d in row] for row in grid], axes


def test_four_ranks_as_two_hosts(tmp_path, monkeypatch):
    """Every rank: the all-reduced ranks 0..3 are 6; the (hosts, ranks)
    grid groups each host's ranks in a row, in rank order, as the JAX
    host_by_device_mesh groups each process's devices; each rank's row and
    column groups reduce over exactly those ranks; one dp NOF step over the
    global mesh gives the same loss on every rank."""
    spec, _, _, params, rays, _, _ = tentry.build_nof(**SMALL, device="cpu")
    rng = np.random.default_rng(0)
    n = SMALL["n_rand"]
    inputs = {"build": SMALL, "params": tnof.params_to_numpy(params),
              "pool": rays.numpy(),
              "draws": [(rng.integers(0, n, n), tuple(
                  rng.random((n, k), dtype=np.float32)
                  for k in (SMALL["n_samples"], SMALL["n_around"], SMALL["n_around"])))]}
    ranks = run_ranks("multihost", 4, inputs, tmp_path, local_world=2)
    jgrid, jaxes = _jax_host_grid(monkeypatch, 2, 2)
    assert jaxes == ("host", "dp")
    for r, out in enumerate(ranks):
        assert out["psum"] == 6.0
        np.testing.assert_array_equal(out["grid"], [[0, 1], [2, 3]])
        # host = process index, rank-in-host = device order within it
        assert [[(g // 2, g) for g in row] for row in out["grid"].tolist()] == jgrid
        assert out["host"] == r // 2
        assert out["axes"] == {"dp": tuple(out["grid"][r // 2]),
                               "host": tuple(out["grid"][:, r % 2])}
        assert out["axis_sums"] == {"dp": float(sum(out["grid"][r // 2])),
                                    "host": float(sum(out["grid"][:, r % 2]))}
        assert out["loss"] == ranks[0]["loss"] and np.isfinite(out["loss"])


def test_init_multihost_without_variables_returns_false(monkeypatch):
    """No coordinator and no process count: the single-process path, no
    process group."""
    for k in ("BSDF_COORDINATOR", "BSDF_NUM_PROCESSES", "BSDF_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_multihost() is False
    assert not dist.is_initialized()
    assert tdist.init_multihost(num_processes=1) is False
    mesh = tdist.global_mesh(device="cpu")
    assert mesh.size == 1 and mesh.rank == 0 and mesh.device == torch.device("cpu")


def test_default_backend(monkeypatch):
    """gloo on the CPU; nccl only when every local rank has a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdist.default_backend(1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tdist.default_backend(2) == "nccl"
    assert tdist.default_backend(4) == "gloo"
