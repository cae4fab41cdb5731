"""A new keyframe's object cloud on the card: the hand-written kernels of
``csrc/fuse_cloud.cu``.

Replaces no TPU kernel.  The JAX package fuses each keyframe's cloud on the
host (``bundlesdf_tpu/io/scene_bounds.py::fuse_frame_cloud``), and so does
the port's on the CPU: its twin is ``io/scene_bounds.py``'s
``voxel_downsample`` and the cKDTree query of
``remove_statistical_outliers``.  For a batch of frames on a CUDA device,
five launches and a stable ``torch.sort`` between them compute each
frame's voxel means, in ``voxel_downsample``'s order and bit for bit, and
each voxel point's k smallest distances to the frame's voxel points,
itself included, bit for bit as ``cKDTree.query`` gives them.  No caller
fuses colours, so the card takes none.  See the source for the design and
the numerics.

Bound on the H100: the neighbour search's f64 operations (1.5 us for a
joint60 frame's ~2.5k voxel points; the bytes the work needs, 2.2 MB, take
0.66 us).  The frames go up through one pinned staging buffer (5 bytes a
pixel: f32 depth and a mask byte); the host reads back each frame's run
count once, sizes the outputs, and reads back the points and distances once
(8 * (3 + k) bytes a voxel point).  All of it runs on the side stream
(``utils/device.py``), so that it never waits behind NOF work on the
current stream.

Routing: ``io/scene_bounds.py::fuse_frame_clouds`` calls ``frame_voxels``
for a CUDA device and runs the twin for any other.  A frame with a voxel
key outside the kernel's packed range (a coordinate past ~10 km, or an inf
depth) raises ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiler
from ..utils.device import side_stream, staging
from ..utils.profiler import span
from . import _cuda_lib

# Frames one batch of launches takes at most.  Device memory a batch: the
# 5-byte upload, keys, sorted keys and their pixels (i64) and run flags,
# their cumsum and run starts (i32), 41 bytes a pixel, and the sort's
# scratch; one 480 x 640 frame's call peaked at 16.4 MB on an H100, so a
# batch of CHUNK such frames holds ~130 MB.
CHUNK = 8

# Launches of the CUDA kernels since the last reset (the twin adds none).
launches = 0


def frame_voxels(depths, masks, K, device, vox: float, k: int) -> list:
    """For each frame (f32 depth, mask): (points, dist) as f64 host arrays,
    the points ``voxel_downsample(pts, None, vox)`` gives for the frame's
    pixels with depth >= 0.1 and mask > 0, and dist each point's ``k``
    smallest distances to the points, ascending (+inf past their count).
    The frames share one shape; ``K`` is their f32 intrinsics.  Raises
    ``ValueError`` for a frame whose voxel keys leave the packed range.
    Spans ``nof/fuse_cloud/device`` a batch; counter
    ``nof/fuse_cloud_frames`` (the frames the card fused)."""
    dev = torch.device(device)
    out = []
    for s in range(0, len(depths), CHUNK):
        with span("nof/fuse_cloud/device"):
            out += _run_kernel(dev, depths[s:s + CHUNK], masks[s:s + CHUNK], K, vox, k)
        profiler.count("nof/fuse_cloud_frames", len(depths[s:s + CHUNK]))
    return out


def _run_kernel(dev, depths, masks, K, vox: float, k: int) -> list:
    """The batch up through the device's ``fuse_cloud`` staging buffer in
    ``pack``'s layout, then ``compute`` on the side stream."""
    B = len(depths)
    H, W = np.shape(depths[0])
    st = staging(dev, "fuse_cloud")
    buf = st.host(upload_bytes(B, H * W))
    pack(depths, masks, buf.numpy())
    stream = side_stream(dev)
    with torch.cuda.stream(stream):
        on_card = buf.to(stream.device, non_blocking=True)
        st.copied(stream)
        return compute(on_card, B, H, W, K, vox, k)


def upload_bytes(n_frames: int, hw: int) -> int:
    """Bytes ``pack`` writes: f32 depth and a mask byte a pixel of each
    frame."""
    return 5 * n_frames * hw


def pack(depths, masks, out: np.ndarray) -> None:
    """The frames into the uint8 array ``out``: every frame's f32 depth,
    then every frame's ``mask > 0`` as a byte."""
    B = len(depths)
    H, W = np.shape(depths[0])
    hw = H * W
    dep = out[:4 * B * hw].view(np.float32).reshape(B, H, W)
    msk = out[4 * B * hw:5 * B * hw].view(np.bool_).reshape(B, H, W)
    for b in range(B):
        np.copyto(dep[b], depths[b], casting="same_kind")
        np.greater(masks[b], 0, out=msk[b])


def _f32(x) -> float:
    return float(np.float32(x))


def _launch(dev, name: str, *args) -> None:
    global launches
    _cuda_lib.launch(dev, name, *args)
    launches += 1
    profiler.count("launch/fuse_cloud")


def compute(on_card: torch.Tensor, B: int, H: int, W: int, K, vox: float, k: int) -> list:
    """``frame_voxels``'s result for ``B`` frames uploaded into the uint8
    tensor ``on_card`` in ``pack``'s layout, on the current stream of its
    device: ``runs`` (keys, sort, run starts), one readback of the run
    counts, ``means_and_neighbours``, one readback of both outputs."""
    t = runs(on_card, B, H, W, K, vox)
    c = t["counts"].cpu().numpy().reshape(B, 2)
    far = np.flatnonzero(c[:, 1])
    if len(far):
        raise ValueError(f"fuse_cloud: frame {int(far[0])} of the batch has a voxel key "
                         "outside the packed range (a coordinate past ~10 km, or an inf "
                         "depth)")
    n = c[:, 0].astype(np.int64)
    offsets = np.zeros(B + 1, np.int32)
    offsets[1:] = np.cumsum(n)
    N = int(offsets[-1])
    host = np.zeros(0)
    if N:
        out = means_and_neighbours(t, torch.from_numpy(offsets).to(on_card.device), N,
                                   int(n.max()), k)
        host = out.cpu().numpy()
    res = []
    for b in range(B):
        lo, hi = int(offsets[b]), int(offsets[b + 1])
        res.append((host[3 * lo:3 * hi].reshape(-1, 3),
                    host[3 * N + k * lo:3 * N + k * hi].reshape(-1, k)))
    return res


def runs(on_card: torch.Tensor, B: int, H: int, W: int, K, vox: float) -> dict:
    """The first three launches over the uploaded batch, with each frame's
    stable sort and the cumsum of the run flags between them: the depth
    view, the sorted keys and their pixels, the run starts and the counts
    (2 ints a frame: runs, key out of range) on the device."""
    hw = H * W
    dev = on_card.device
    K = np.asarray(K, np.float32)
    t = {"B": B, "H": H, "W": W,
         "cam": (_f32(K[0, 0]), _f32(K[1, 1]), _f32(K[0, 2]), _f32(K[1, 2])),
         "depth": on_card[:4 * B * hw].view(torch.float32)}
    mask = on_card[4 * B * hw:5 * B * hw]
    keys = torch.empty(B * hw, dtype=torch.int64, device=dev)
    t["counts"] = torch.zeros(2 * B, dtype=torch.int32, device=dev)
    _launch(dev, "fuse_cloud_keys", t["depth"].data_ptr(), mask.data_ptr(), B, H, W,
            *t["cam"], _f32(vox), keys.data_ptr(), t["counts"].data_ptr())
    t["sorted"], t["perm"] = torch.sort(keys.view(B, hw), dim=1, stable=True)
    flags = torch.empty(B * hw, dtype=torch.int32, device=dev)
    _launch(dev, "fuse_cloud_flags", t["sorted"].data_ptr(), B, hw, flags.data_ptr())
    cum = torch.cumsum(flags.view(B, hw), dim=1, dtype=torch.int32)
    t["starts"] = torch.empty(B * hw, dtype=torch.int32, device=dev)
    _launch(dev, "fuse_cloud_starts", flags.data_ptr(), cum.data_ptr(), B, hw,
            t["starts"].data_ptr(), t["counts"].data_ptr())
    return t


def means_and_neighbours(t: dict, offsets: torch.Tensor, N: int, max_runs: int,
                         k: int) -> torch.Tensor:
    """The last two launches over ``runs``'s tensors, each frame's outputs
    from row ``offsets[b]`` (int32 on the device) of ``N`` in all: one f64
    tensor of the points (N x 3) and the distances (N x k)."""
    dev = offsets.device
    out = torch.empty(N * (3 + k), dtype=torch.float64, device=dev)
    pts = out[:3 * N]
    dist = out[3 * N:]
    _launch(dev, "fuse_cloud_means", t["depth"].data_ptr(), t["sorted"].data_ptr(),
            t["perm"].data_ptr(), t["starts"].data_ptr(), t["counts"].data_ptr(),
            offsets.data_ptr(), t["B"], t["H"], t["W"], *t["cam"], max_runs,
            pts.data_ptr())
    _launch(dev, "fuse_cloud_knn", pts.data_ptr(), t["counts"].data_ptr(), offsets.data_ptr(),
            t["B"], max_runs, k, dist.data_ptr())
    return out
