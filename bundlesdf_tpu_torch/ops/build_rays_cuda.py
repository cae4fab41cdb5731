"""A round's new NOF rays built on the card: the hand-written kernels of
``csrc/build_rays.cu``.

Replaces no TPU kernel.  The JAX package builds a round's rays on the host
(``bundlesdf_tpu/nof/runner.py``), and so does the port's on the CPU: its
twin is ``nof/runner.py::NofRunner._build_all_rays`` (the square mask
dilation and the gathers of ``_build_frame_rays``, the ray/box clip, the
torch march of ``_cull_rays_by_occupancy`` and the cKDTree of
``_denoise_rays_by_cloud``).  For a batch of frames on a CUDA device the
kernels select the pixels, clip, cull and denoise each candidate ray,
compact the kept rows in the twin's order (frame, then row-major pixel)
and, once the pool has room for them, write them there: bit for bit the
twin's rows.  See the source for the design and the numerics.

Bound on the H100: the bytes the work needs (30 a pixel read, 48 a kept
row written) take 3.3 us for a 480 x 640 joint60 keyframe; the march's
dependent grid reads, which that leaves out, take most of the kernels'
~0.19 ms.  The frames go up through the pinned staging buffer of
``nof_frames`` (``utils/device.py``) in copies of at most ``STAGE_BYTES``,
counted in ``nof/pool_upload_bytes`` as the rows were; the host reads back
one count a call.  Everything runs on the current stream, behind the NOF
steps already queued there, as the twin's cull and the pool's writes do.

Routing: ``NofRunner._build_all_rays`` calls ``build`` for a CUDA device
and runs the twin for any other; the pool (``NofRunner._upload_rays``)
takes the ``Rays`` it returns and calls ``write`` with the rows' place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiler
from ..utils.device import staging
from ..utils.profiler import span
from . import _cuda_lib

# A frame's parameters: R row-major and t (12 f32), the frame id and the
# mask dilation (2 i32), padded to 16 words.
PARAM_WORDS = 16
# The kernels' option bits.
HAS_OCC, VALID_DEPTH_ONLY, DENOISE = 1, 2, 4
# ints a tile of csrc/build_rays.cu's scan (kScanTile)
SCAN_TILE = 2048
# The denoise grid: a cell this much wider than the radius, and at most this
# many cells (wider cells past it; a cell is never narrower than the radius).
CELL_MARGIN = 1.0625
MAX_CELLS = 1 << 24
# The most bytes one copy through the staging buffer carries.
STAGE_BYTES = 64 << 20

# Launches of the CUDA kernels since the last reset (the twin adds none).
launches = 0


class Rules(NamedTuple):
    """What the twin reads of the runner's config: near and far times
    sc_factor (compared with f32 depths in f32), the denoise radius
    0.02 * sc_factor (f64), the march's steps, and the two switches."""
    near_sc: float
    far_sc: float
    radius: float
    n_march: int
    valid_depth_only: bool
    denoise: bool


class Rays:
    """A batch's kept rows on the card, not yet written: ``len`` is their
    count, the one value read back; ``write(dst)`` puts them, in the twin's
    order, into ``dst``, a contiguous (len, 12) f32 tensor on the card (the
    pool's rows from ``n_old``, or the grown rows a capped round draws
    from), and lets the batch go."""

    def __init__(self, t: dict, n: int):
        self._t = t
        self.n = n

    def __len__(self) -> int:
        return self.n

    def write(self, dst: torch.Tensor) -> None:
        t = self._t
        if t is None:
            raise RuntimeError("these rays were written already")
        if (tuple(dst.shape) != (self.n, 12) or not dst.is_contiguous()
                or dst.dtype != torch.float32 or dst.device != t["dev"]):
            raise ValueError(f"contiguous f32 rows of {self.n} x 12 on {t['dev']} expected, "
                             f"got {tuple(dst.shape)} {dst.dtype} on {dst.device}")
        if self.n:
            write(t, dst)
        self._t = None


def layout(B: int, H: int, W: int) -> tuple:
    """(param_bytes, stride, total): the batch's upload holds the frames'
    parameters, then frame b at ``param_bytes + b * stride``: f32 colour
    (3 a pixel), f32 depth, the mask byte and the occlusion byte."""
    param_bytes = -(-4 * PARAM_WORDS * B // 256) * 256
    stride = -(-18 * H * W // 256) * 256
    return param_bytes, stride, param_bytes + B * stride


def pack_params(fids, poses, dilations, out: np.ndarray) -> None:
    """Each frame's R, t, id and dilation into the uint8 ``out`` (the
    upload's first ``param_bytes``)."""
    B = len(fids)
    words = out[:4 * PARAM_WORDS * B].view(np.float32).reshape(B, PARAM_WORDS)
    words[:] = 0
    poses = np.asarray(poses, np.float32)
    words[:, :9] = poses[:, :3, :3].reshape(B, 9)
    words[:, 9:12] = poses[:, :3, 3]
    ints = words.view(np.int32)
    ints[:, 12] = fids
    ints[:, 13] = dilations


def pack_frame(rgb, depth, mask, occ, out: np.ndarray) -> None:
    """One frame into the uint8 ``out`` (its ``stride`` bytes): colour and
    depth as f32, ``mask > 0`` and ``occ > 0`` (zeros without one) as
    bytes."""
    hw = np.shape(depth)[0] * np.shape(depth)[1]
    np.copyto(out[:12 * hw].view(np.float32).reshape(np.shape(rgb)), rgb, casting="same_kind")
    np.copyto(out[12 * hw:16 * hw].view(np.float32).reshape(np.shape(depth)), depth,
              casting="same_kind")
    np.greater(mask, 0, out=out[16 * hw:17 * hw].view(np.bool_).reshape(np.shape(depth)))
    occ_out = out[17 * hw:18 * hw].view(np.bool_).reshape(np.shape(depth))
    if occ is None:
        occ_out[:] = False
    else:
        np.greater(occ, 0, out=occ_out)


def build(dev, frames: tuple, fids, poses, dilations, rules: Rules, dirs: torch.Tensor,
          grid: torch.Tensor, cloud: np.ndarray, cloud_dev: torch.Tensor) -> Rays:
    """The rows ``_build_all_rays``' twin builds for ``fids``, on the card.
    ``frames``: (images, depths, masks, occ_masks or None), each indexable
    by frame id; ``poses``: the frames' (B, 4, 4) f32 c2w;
    ``dilations``: each frame's dilation size; ``dirs``: the cached camera
    directions (H, W, 3) and ``grid`` the occupancy grid, on the card;
    ``cloud``: the build cloud (host f32, for the denoise grid's bounds) and
    ``cloud_dev`` the same points on the card.  Span
    ``nof/build_rays/device``; counter ``nof/build_rays_device_frames``."""
    dev = torch.device(dev)
    with span("nof/build_rays/device"):
        rays = _run_kernel(dev, frames, fids, poses, dilations, rules, dirs, grid, cloud,
                           cloud_dev)
    profiler.count("nof/build_rays_device_frames", len(fids))
    return rays


def _run_kernel(dev, frames, fids, poses, dilations, rules, dirs, grid, cloud, cloud_dev):
    """The batch up through the ``nof_frames`` staging buffer in ``layout``,
    frames at a time, then ``compute`` on the current stream."""
    images, depths, masks, occ = frames
    B = len(fids)
    H, W = np.shape(depths[0])
    param_bytes, stride, total = layout(B, H, W)
    on_card = torch.empty(total, dtype=torch.uint8, device=dev)
    profiler.count("nof/pool_upload_bytes", total)
    st = staging(dev, "nof_frames")
    stream = torch.cuda.current_stream(dev)
    buf = st.host(param_bytes)
    pack_params(fids, poses, dilations, buf.numpy())
    on_card[:param_bytes].copy_(buf, non_blocking=True)
    st.copied(stream)
    per = max(1, STAGE_BYTES // stride)
    for s in range(0, B, per):
        n = min(per, B - s)
        buf = st.host(n * stride)
        host = buf.numpy()
        for j, f in enumerate(fids[s:s + n]):
            pack_frame(images[f], depths[f], masks[f], None if occ is None else occ[f],
                       host[j * stride:(j + 1) * stride])
        lo = param_bytes + s * stride
        on_card[lo:lo + n * stride].copy_(buf, non_blocking=True)
        st.copied(stream)
    return compute(on_card, B, H, W, occ is not None, rules, dirs, grid, cloud, cloud_dev)


def _f32(x) -> float:
    return float(np.float32(x))


def _launch(dev, name: str, *args) -> None:
    global launches
    _cuda_lib.launch(dev, name, *args)
    launches += 1
    profiler.count("launch/build_rays")


def scan(dev, data: torch.Tensor) -> torch.Tensor:
    """``data`` (int32 on the device) scanned in place, exclusive; returns
    its total as a one-int tensor on the device."""
    n = data.numel()
    sums = torch.empty(-(-n // SCAN_TILE), dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    _launch(dev, "build_rays_scan", data.data_ptr(), n, sums.data_ptr(), total.data_ptr())
    return total


def cloud_grid(dev, cloud: np.ndarray, cloud_dev: torch.Tensor, radius: float) -> dict:
    """The denoise's uniform grid of the build cloud on the card: cells at
    least ``CELL_MARGIN`` times the radius wide over the cloud's bounds with
    a cell to spare on each side, the points sorted by cell and each cell's
    first point (the bounds from the host copy, the rest on the card)."""
    n = len(cloud)
    lo = cloud.min(axis=0).astype(np.float64)
    ext = cloud.max(axis=0).astype(np.float64) - lo
    cell = radius * CELL_MARGIN if radius > 0 else 1.0
    while True:
        dims = [int(math.floor(e / cell)) + 3 for e in ext]
        if math.prod(dims) <= MAX_CELLS:
            break
        cell *= 1.25
    lo = lo - cell
    inv = 1.0 / cell
    n_cells = math.prod(dims)
    cell_of = torch.empty(n, dtype=torch.int32, device=dev)
    starts = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    geo = (*map(float, lo), inv, *dims)
    _launch(dev, "build_rays_cloud_cells", cloud_dev.data_ptr(), n, *geo, cell_of.data_ptr(),
            starts.data_ptr())
    scan(dev, starts)
    fill = torch.zeros(n_cells, dtype=torch.int32, device=dev)
    pts = torch.empty(3 * n, dtype=torch.float32, device=dev)
    _launch(dev, "build_rays_cloud_fill", cloud_dev.data_ptr(), n, cell_of.data_ptr(),
            starts.data_ptr(), fill.data_ptr(), pts.data_ptr())
    return {"pts": pts, "starts": starts, "n": n, "geo": geo}


def compute(on_card: torch.Tensor, B: int, H: int, W: int, has_occ: bool, rules: Rules,
            dirs: torch.Tensor, grid: torch.Tensor, cloud: np.ndarray,
            cloud_dev: torch.Tensor) -> Rays:
    """``build``'s result for ``B`` frames uploaded into the uint8 tensor
    ``on_card`` in ``layout``, on the current stream of its device:
    ``positions``, then one readback of the count."""
    t = positions(on_card, B, H, W, has_occ, rules, dirs, grid, cloud, cloud_dev)
    return Rays(t, int(t["total"].item()))


def positions(on_card: torch.Tensor, B: int, H: int, W: int, has_occ: bool, rules: Rules,
              dirs: torch.Tensor, grid: torch.Tensor, cloud: np.ndarray,
              cloud_dev: torch.Tensor) -> dict:
    """The launches before the readback: the selection, the denoise grid,
    the keep flags and their scan (each kept row's position), on the
    device, with the count there as ``total``."""
    dev = on_card.device
    hw = H * W
    param_bytes, stride, total = layout(B, H, W)
    R = grid.shape[0]
    if (on_card.dtype != torch.uint8 or on_card.numel() < total
            or dirs.shape != (H, W, 3) or dirs.dtype != torch.float32
            or not dirs.is_contiguous() or grid.shape != (R, R, R)
            or grid.dtype not in (torch.bool, torch.uint8)
            or cloud_dev.shape != (len(cloud), 3) or cloud_dev.dtype != torch.float32
            or not cloud_dev.is_contiguous()
            or any(t.device != dev for t in (dirs, grid, cloud_dev))):
        raise ValueError("build_rays: the upload, directions, occupancy grid or cloud do not "
                         "match the batch")
    batch = (on_card.data_ptr() + param_bytes, stride, on_card.data_ptr(), B, H, W)
    opts = ((HAS_OCC if has_occ else 0) | (VALID_DEPTH_ONLY if rules.valid_depth_only else 0)
            | (DENOISE if rules.denoise else 0))
    rowmax = torch.empty(B * hw, dtype=torch.uint8, device=dev)
    cand = torch.empty(B * hw, dtype=torch.uint8, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    _launch(dev, "build_rays_select", *batch, _f32(rules.near_sc), _f32(rules.far_sc), opts,
            rowmax.data_ptr(), cand.data_ptr(), counts.data_ptr())
    del rowmax
    g = None
    if rules.denoise and len(cloud):
        g = cloud_grid(dev, cloud, cloud_dev, rules.radius)
    none = (0, 0, 0, 0.0, 0.0, 0.0, 1.0, 1, 1, 1)
    cloud_args = none if g is None else (g["pts"].data_ptr(), g["starts"].data_ptr(), g["n"],
                                         *g["geo"])
    grid = grid.contiguous()
    keep = torch.zeros(B * hw + 1, dtype=torch.int32, device=dev)
    nearfar = torch.empty(2 * B * hw, dtype=torch.float32, device=dev)
    _launch(dev, "build_rays_flags", *batch, dirs.data_ptr(), cand.data_ptr(),
            counts.data_ptr(), grid.data_ptr(), R, rules.n_march,
            _f32(rules.far_sc), opts, *cloud_args, float(rules.radius), keep.data_ptr(),
            nearfar.data_ptr())
    total = scan(dev, keep)
    return {"dev": dev, "batch": batch, "on_card": on_card, "dirs": dirs, "keep": keep,
            "nearfar": nearfar, "total": total}


def write(t: dict, dst: torch.Tensor) -> None:
    """The kept rows of ``positions``' batch ``t`` into the contiguous f32
    rows ``dst`` on its device."""
    _launch(t["dev"], "build_rays_write", *t["batch"], t["dirs"].data_ptr(),
            t["keep"].data_ptr(), t["nearfar"].data_ptr(), dst.data_ptr())
