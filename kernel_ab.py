#!/usr/bin/env python3
"""A/B of the port's CUDA kernels against those of another tree of this
repository (for example the parent commit) on one GPU, with one timer.

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 kernel_ab.py --parent build/parent

It loads the other tree's ``bundlesdf_tpu_torch`` under another name beside
this tree's, builds both kernel libraries from their own sources, and
times each kernel of both trees on the same inputs in turns (parent,
change, change, parent) with ``chip_smoke.py``'s timers: device time of 20
calls queued behind a device-side spin (``cuda_ms``) and host time per call
over 100 calls (``host_us``).  Each kernel's output is held against this
tree's plain version with ``chip_smoke.py``'s tolerances.

Inputs: the seeded inputs of ``chip_smoke.py``'s ``kernels`` phase
(reduce at R = 64 and 128; scatter on uniform and on ray-major cells), and
the inputs one online-budget train step under ``hash_scatter: pallas`` hands
each kernel (``in_situ``).  It prints the card's name and power limit, one
JSON line per case, and ``{"ok": true, ...}`` last.  It needs one CUDA
device and imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke


def load_tree(root: Path, alias: str):
    """Import ``root/bundlesdf_tpu_torch`` as package ``alias``; return its
    (reduce_cuda, hashgrid_cuda) modules."""
    pkg = root / "bundlesdf_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{alias}.ops.reduce_cuda"),
            importlib.import_module(f"{alias}.ops.hashgrid_cuda"))


def in_situ_inputs(device) -> tuple[list, list]:
    """The reduce and scatter calls of the 4th online-budget train step
    under hash_scatter: pallas."""
    import torch

    from bundlesdf_tpu_torch.ops import hashgrid_cuda, reduce_cuda

    _, params, step, rays, c2w, grid, _ = chip_smoke.make_step(
        chip_smoke.ONLINE, "pallas", device)
    gen = torch.Generator(device=device).manual_seed(1)
    for i in range(3):
        step(params, i, rays, rays.shape[0], grid, c2w, generator=gen)
    red, sca = [], []
    with chip_smoke.record_calls(reduce_cuda, "reduce_cell_cache_grad", red), \
            chip_smoke.record_calls(hashgrid_cuda, "fused_cache_scatter", sca):
        step(params, 3, rays, rays.shape[0], grid, c2w, generator=gen)
    torch.cuda.synchronize()
    return red, sca


def ab(case: str, sides: dict, check) -> dict:
    """Time each side's call in turns parent, change, change, parent;
    ``check(out)`` gives the max abs error of one output."""
    row = {"case": case}
    for name, fn in sides.items():
        row[f"{name}_max_abs_err"] = check(fn())
    for name in ("parent", "change", "change", "parent"):
        row.setdefault(f"{name}_ms", []).append(chip_smoke.cuda_ms(sides[name]))
        row.setdefault(f"{name}_host_us", []).append(chip_smoke.host_us(sides[name]))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other tree (holds bundlesdf_tpu_torch/)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    device = torch.device("cuda", 0)

    from bundlesdf_tpu_torch.ops import _cuda_lib, hashgrid_cuda, reduce_cuda

    p_reduce, p_scatter = load_tree(args.parent.resolve(), "parent_bundlesdf_tpu_torch")
    _cuda_lib.build(force=True)
    sys.modules["parent_bundlesdf_tpu_torch.ops._cuda_lib"].build(force=True)
    sides = {"parent": (p_reduce, p_scatter), "change": (reduce_cuda, hashgrid_cuda)}

    def reduce_case(case, d_cache, R, size):
        ref = reduce_cuda.reduce_cell_cache_grad_plain(d_cache, R, 2, size)
        tol = chip_smoke.REDUCE_RTOL * max(1.0, float(ref.abs().max()))
        row = ab(case, {k: (lambda m=m: m[0].reduce_cell_cache_grad(d_cache, R, 2, size))
                        for k, m in sides.items()},
                 lambda out: chip_smoke.max_err(out, ref))
        row.update(R=R, tol=tol)
        return row

    def scatter_case(case, cells, d_rows, rows):
        refs = hashgrid_cuda.fused_cache_scatter_plain(cells, d_rows, rows)
        tol = min(chip_smoke.SCATTER_RTOL * max(1.0, float(r.abs().max()))
                  for r in refs)
        row = ab(case, {k: (lambda m=m: m[1].fused_cache_scatter(cells, d_rows, rows))
                        for k, m in sides.items()},
                 lambda outs: max(chip_smoke.max_err(o, r) for o, r in zip(outs, refs)))
        row.update(rows=rows, tol=tol,
                   mean_run=[chip_smoke.mean_run(c) for c in cells])
        return row

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for R in (64, 128):
        d_cache = torch.randn((R ** 3, 16), generator=gen, device=device).to(torch.bfloat16)
        rows.append(reduce_case(f"reduce R={R} seeded", d_cache, R,
                                -(-(R + 1) ** 3 // 8) * 8))
    on = chip_smoke.ONLINE
    n = on["n_rand"] * (on["n_samples"] + on["n_around"])
    uniform = torch.randint(0, 16 ** 3, (n,), generator=gen, device=device,
                            dtype=torch.int32)
    ray = chip_smoke.ray_major_cells(on["n_rand"], on["n_samples"], on["n_around"],
                                     16, gen, device)
    for case, cells in (("scatter uniform cells", uniform),
                        ("scatter ray-major cells", ray)):
        d_rows = torch.randn((n, 16), generator=gen, device=device)
        rows.append(scatter_case(case, [cells], [d_rows], [16 ** 3]))
    red_calls, sca_calls = in_situ_inputs(device)
    for d, R, C, size in red_calls:
        rows.append(reduce_case(f"reduce R={R} in situ", d.contiguous(), R, size))
    for c, u, r in sca_calls:
        rows.append(scatter_case("scatter in situ", list(c), list(u), [int(x) for x in r]))
    for row in rows:
        for side in ("parent", "change"):
            if not row[f"{side}_max_abs_err"] <= row["tol"]:
                raise AssertionError(f"{row['case']}: {side} disagrees with plain: {row}")
        chip_smoke.emit(row)
    chip_smoke.emit({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
