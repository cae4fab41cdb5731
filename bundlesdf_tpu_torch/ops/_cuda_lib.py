"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface.  At first use each source is
compiled by ``nvcc`` for ``sm_90a`` (all sources at once, one process
each), the objects are linked into one shared library under
``build/bundlesdf_tpu_torch/`` beside the package, and the library is
loaded with ``ctypes``.  The library's file name carries a digest of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built when a module is imported: the CPU tests
import every module and never reach this code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bundlesdf_tpu_torch"
SOURCES = ("reduce_cell_cache_grad.cu", "fused_cache_scatter.cu", "depth_frame.cu",
           "covisibility.cu", "fuse_cloud.cu", "build_rays.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# C entry points and their ctypes argument types (pointers and the stream
# as c_void_p so they are not cut to 32 bits).
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_int64
_SIGNATURES = {
    "reduce_cell_cache_grad_bf16": (_P, _P, _I, _I, ctypes.c_int64, _I, _I, _I,
                                    _I, _I, _P),
    "fused_cache_scatter_f32": (_P, _P, _I, _I, _I, _P),
    "depth_frame_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _I,
                        _F, _F, _I, _P, _F, _D, _P),
    "covisibility_count_f32": (_P, _P, _P, _P, _I, _I, _F, _P, _P, _P),
    "fuse_cloud_keys": (_P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P),
    "fuse_cloud_flags": (_P, _I, _I, _P, _P),
    "fuse_cloud_starts": (_P, _P, _I, _I, _P, _P, _P),
    "fuse_cloud_means": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P, _P),
    "fuse_cloud_knn": (_P, _P, _P, _I, _I, _I, _P, _P),
    "build_rays_select": (_P, _L, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P, _P),
    "build_rays_flags": (_P, _L, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _I,
                         _D, _D, _D, _D, _I, _I, _I, _D, _P, _P, _P),
    "build_rays_scan": (_P, _L, _P, _P, _P),
    "build_rays_write": (_P, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    "build_rays_cloud_cells": (_P, _I, _D, _D, _D, _D, _I, _I, _I, _P, _P, _P),
    "build_rays_cloud_fill": (_P, _I, _P, _P, _P, _P, _P),
}


# The kernel wrappers: each counts its kernel's launches in its module's
# ``launches`` (one per host call that launches it).
COUNTED = ("reduce_cuda", "hashgrid_cuda", "depth_cuda", "covisibility_cuda",
           "fuse_cloud_cuda", "build_rays_cuda")


def launch_counts() -> dict:
    """Each wrapper module's ``launches``, by module name."""
    return {m: importlib.import_module(f"{__package__}.{m}").launches for m in COUNTED}


def add_launches(per: dict, times: int) -> None:
    """Add ``per[m] * times`` to module ``m``'s ``launches``: a replayed
    CUDA graph launches what its capture recorded, with no host call."""
    for m, n in per.items():
        mod = importlib.import_module(f"{__package__}.{m}")
        mod.launches += n * times


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libbundlesdf_tpu_torch_kernels-{_digest()}.so"


def build(force: bool = False) -> dict:
    """Compile every source in parallel and link the shared library.

    Returns {"path", "seconds", "log"}; ``log`` holds nvcc's output,
    including ``-Xptxas -v`` register and spill counts.  Raises with the
    compiler's output if any step fails."""
    out = lib_path()
    if out.exists() and not force:
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{_digest()}-{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = []
    failed = []
    for s, p in zip(SOURCES, procs):
        text, _ = p.communicate()
        logs.append(f"== {s}\n{text}")
        if p.returncode != 0:
            failed.append(s)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "log": log}


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its signatures."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(dev, name: str, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    CUDA device ``dev``, with ``dev`` made current only if it is not, and
    raise if it reports a CUDA error."""
    fn = getattr(load(), name)
    # the handle torch.cuda.current_stream(dev).cuda_stream gives, without
    # building a Stream object on every call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
