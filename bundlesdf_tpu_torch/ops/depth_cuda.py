"""The tracker's depth pipeline on the card: the hand-written kernel
``csrc/depth_frame.cu`` and its host twin.

Replaces no TPU kernel.  The JAX Frame runs the chain on the host
(``bundlesdf_tpu/ops/image.py::process_depth_frame_np``), and so does the
port's on the CPU.  On a CUDA tracker one launch computes what
``image.process_depth_frame_np`` and the Frame's fg / occ mask
invalidation compute (the zfar clamp, the erode, two bilateral passes, xyz,
normals, the edge-grazing filter, the valid rule, the masks), bit for bit;
see the source for the design and the numerics.

Bound on the H100: memory, 6 bytes a pixel read (raw depth and both
masks) and 29 written (depth, xyz, normals, valid): 10.7 MB at 480 x 640,
3.2 us at 3.35 TB/s.  The card's time is small beside the copies around
it: one upload of the raw depth and the masks, the launch, and one
readback of the four maps, through one pinned staging buffer and on the
tracker's side stream (``utils/device.py``), so that the frame never waits
behind NOF work on the current stream; the host waits on the staging
buffer's event only, then copies the maps into the Frame's own arrays.

Routing: a CUDA device launches the kernel, except where the radii need a
halo wider than the kernel's tile takes (``kernel_takes``), which runs the
twin; any other device runs the twin.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.device import side_stream, staging
from ..utils.profiler import span
from . import _cuda_lib
from . import image as image_ops

# The kernel's compile-time tile and the widest halo it takes (kTileY,
# kTileX, kMaxHalo in the .cu source).
TILE_Y = 32
TILE_X = 32
MAX_HALO = 16

# Launches of the CUDA kernel since the last reset (the twin adds none).
launches = 0


def halo(erode_radius: int, bilateral_radius: int) -> int:
    """Pixels of raw depth a tile needs around it: the erode, two bilateral
    passes and the normals' 3 x 3 stencil."""
    return erode_radius + 2 * bilateral_radius + 1


def kernel_takes(erode_radius: int, bilateral_radius: int) -> bool:
    """Whether the kernel computes these radii (else the twin runs)."""
    return (erode_radius >= 0 and bilateral_radius >= 0
            and halo(erode_radius, bilateral_radius) <= MAX_HALO)


def config_params(dp) -> dict:
    """The pipeline's parameters from a tracker config's
    ``depth_processing`` group."""
    return dict(zfar=float(dp["zfar"]),
                erode_radius=int(dp["erode"]["radius"]),
                erode_diff=float(dp["erode"]["diff"]),
                erode_ratio=float(dp["erode"]["ratio"]),
                bilateral_radius=int(dp["bilateral_filter"]["radius"]),
                sigma_d=float(dp["bilateral_filter"]["sigma_D"]),
                sigma_r=float(dp["bilateral_filter"]["sigma_R"]),
                edge_normal_thres_deg=float(dp["edge_normal_thres"]))


def invalidate(maps: tuple, keep_mask: np.ndarray) -> tuple:
    """(depth, xyz, normals, valid) with the pixels outside ``keep_mask``
    zeroed (reference Frame.cpp:432-451 invalidatePixelsByMask)."""
    depth, xyz, normals, valid = maps
    keep = keep_mask > 0
    return (np.where(keep, depth, 0.0), np.where(keep[..., None], xyz, 0.0),
            np.where(keep[..., None], normals, 0.0), valid & keep)


def _f32(x) -> float:
    """``x`` rounded to f32, as numpy rounds a Python scalar against an f32
    array."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def kernel_constants(bilateral_radius: int, sigma_d: float, sigma_r: float,
                     edge_normal_thres_deg: float) -> tuple:
    """The bilateral's spatial weights (f64, dy outer, dx inner), its range
    factor in f32 and the edge test's min_cos (f64), each computed as
    ``image.process_depth_frame_np`` computes it."""
    r = bilateral_radius
    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    inv_2sr2 = 1.0 / (2.0 * sigma_r * sigma_r)
    ws = np.array([np.exp(-(dy * dy + dx * dx) * inv_2sd2)
                   for dy in range(-r, r + 1) for dx in range(-r, r + 1)], np.float64)
    ws.setflags(write=False)
    min_cos = float(np.sin(np.deg2rad(edge_normal_thres_deg)))
    return ws, _f32(inv_2sr2), min_cos


def process_depth_frame(depth, K, device, fg_mask=None, occ_mask=None, **params):
    """``image.process_depth_frame_np(depth, K, **params)`` (every keyword
    given, as ``config_params`` gives them) with the pixels outside
    ``fg_mask`` and inside ``occ_mask`` invalidated after it, as the Frame
    does: (depth, xyz, normals, valid) as host arrays (f32, f32, f32, bool).
    ``K`` is the Frame's f32 intrinsics.  On a CUDA ``device`` one kernel
    launch computes them (``launches`` counts it); elsewhere, or for radii
    the kernel does not take, the twin runs."""
    dev = torch.device(device)
    if dev.type != "cuda" or not kernel_takes(params["erode_radius"],
                                              params["bilateral_radius"]):
        maps = image_ops.process_depth_frame_np(depth, K, **params)
        if fg_mask is not None:
            maps = invalidate(maps, fg_mask)
        if occ_mask is not None:
            maps = invalidate(maps, ~(np.asarray(occ_mask) > 0))
        return maps
    with span("track/depth/device"):
        return _run_kernel(dev, depth, K, fg_mask, occ_mask, params)


def _run_kernel(dev, depth, K, fg_mask, occ_mask, p: dict) -> tuple:
    """Upload, one launch, one readback, on the tracker's side stream,
    through the device's ``depth`` staging buffer: the raw depth and masks
    (6 bytes a pixel), then the four maps read back behind them (29)."""
    depth = np.asarray(depth, np.float32)
    K = np.asarray(K, np.float32)
    H, W = depth.shape
    hw = H * W
    st = staging(dev, "depth")
    buf = st.host(35 * hw)
    host = buf.numpy()
    np.copyto(host[:4 * hw].view(np.float32).reshape(H, W), depth)
    fg = host[4 * hw:5 * hw].reshape(H, W)
    if fg_mask is None:
        fg.fill(1)
    else:
        np.greater(fg_mask, 0, out=fg.view(np.bool_))
    if occ_mask is not None:
        np.greater(occ_mask, 0, out=host[5 * hw:6 * hw].reshape(H, W).view(np.bool_))
    stream = side_stream(dev)
    with torch.cuda.stream(stream):
        on_card = torch.empty(35 * hw, dtype=torch.uint8, device=stream.device)
        on_card[:6 * hw].copy_(buf[:6 * hw], non_blocking=True)
        _launch(on_card, H, W, K, p, occ_mask is not None)
        buf[6 * hw:].copy_(on_card[6 * hw:], non_blocking=True)
        st.copied(stream)
    st.wait()
    out = host[6 * hw:]
    return (out[:4 * hw].view(np.float32).reshape(H, W).copy(),
            out[4 * hw:16 * hw].view(np.float32).reshape(H, W, 3).copy(),
            out[16 * hw:28 * hw].view(np.float32).reshape(H, W, 3).copy(),
            out[28 * hw:29 * hw].view(np.bool_).reshape(H, W).copy())


def _launch(on_card: torch.Tensor, H: int, W: int, K: np.ndarray, p: dict,
            has_occ: bool) -> None:
    """The kernel on the current stream over ``on_card``: an (H, W) frame's
    uploaded inputs (6 bytes a pixel) to its four maps behind them (29)."""
    global launches
    hw = H * W
    ws, inv_2sr2, min_cos = kernel_constants(p["bilateral_radius"], p["sigma_d"],
                                             p["sigma_r"], p["edge_normal_thres_deg"])
    base_in = on_card.data_ptr()
    base_out = base_in + 6 * hw
    _cuda_lib.launch(
        on_card.device, "depth_frame_f32", base_in, base_in + 4 * hw,
        base_in + 5 * hw if has_occ else None,
        base_out, base_out + 4 * hw, base_out + 16 * hw, base_out + 28 * hw,
        H, W, _f32(K[0, 0]), _f32(K[1, 1]), _f32(K[0, 2]), _f32(K[1, 2]),
        _f32(p["zfar"]), p["erode_radius"], _f32(p["erode_diff"]),
        _f32(p["erode_ratio"]), p["bilateral_radius"],
        ws.ctypes.data_as(ctypes.c_void_p), inv_2sr2, min_cos)
    launches += 1
