"""The one owner of a tracked frame's device copies (port of
``bundlesdf_tpu/tracking/device_pool.py``, with the covisibility copies).

The reference keeps every frame's maps on the GPU while the frame lives
(Frame.cpp:80-138; CUDACache for BA).  The pool holds two kinds of copy:
the fused programs' slot planes (one packed upload a frame, 6 bytes a
pixel: gray u8, depth u16 at 0.1 mm, normals i8, decoded on the device into
float32 planes made at the first ``ensure``, LRU over ``capacity`` slots),
and the covisibility kernel's stride-2 copies (``ops/covisibility_cuda.py``,
one tensor a frame queried as A).  A copy is made again when its Frame's
``version`` has moved since, and ``release`` frees both kinds.  Uploads go
through the staging buffers of ``utils/device.py``: the slots on the current
stream, where the fused programs read them, the copies on the side stream.

Quantization: depth 0.1 mm steps (sensor noise ~1 mm; RANSAC inlier_dist
5 mm), normals 1/127 (~0.5 deg; the normal gate is 30 deg).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import covisibility_cuda
from ..utils import profiler
from ..utils.device import resolve_device, side_stream, staging


def _pool_update(gray_pool, depth_pool, normal_pool, packed: torch.Tensor, slot: int):
    """Decode one frame's packed u8 buffer into pool ``slot`` (in place).

    packed layout (u8): [H*W gray u8 | H*W*2 depth u16-LE | H*W*3 normal i8].
    Depth is rebuilt from its two bytes in int32 (torch's uint16 support is
    partial).  The normals' /127 is a multiply by the f32 reciprocal, as
    XLA compiles the JAX division, so both pools agree bitwise."""
    _, H, W = gray_pool.shape
    hw = H * W
    gray_pool[slot] = packed[:hw].reshape(H, W).to(torch.float32)
    d = packed[hw:3 * hw].reshape(hw, 2).to(torch.int32)
    d16 = d[:, 0] + d[:, 1] * 256
    depth_pool[slot] = (d16.to(torch.float32) * 1e-4).reshape(H, W)
    n8 = packed[3 * hw:6 * hw].view(torch.int8)
    normal_pool[slot] = (n8.to(torch.float32) * (1.0 / 127.0)).reshape(H, W, 3)


class DeviceFramePool:
    def __init__(self, capacity: int = 64, device=None):
        self.device = resolve_device(device)
        self.capacity = capacity
        # the slot planes and the intrinsics, made at the first ensure
        self.gray = self.depth = self.normals = self.K = None
        self.slot_of: dict[int, int] = {}
        self.stride2: dict[int, torch.Tensor] = {}   # the covisibility copies
        # (kind, frame id) -> (frame, version) that copy was made from
        self._made: dict[tuple, tuple] = {}
        self._use_tick: dict[int, int] = {}
        self._tick = 0

    def _fresh(self, kind: str, frame) -> bool:
        return self._made.get((kind, frame.id)) == (frame, frame.version)

    # ------------------------------------------------------------------
    def ensure(self, frames) -> list[int]:
        """Return pool slots for ``frames``, uploading any not resident or
        stale.  Frames in this batch are protected from eviction."""
        if self.gray is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            H, W = frames[0].H, frames[0].W
            self.gray = torch.zeros((self.capacity, H, W), **f32)
            self.depth = torch.zeros((self.capacity, H, W), **f32)
            self.normals = torch.zeros((self.capacity, H, W, 3), **f32)
            self.K = torch.as_tensor(frames[0].K, device=self.device)
        batch_ids = {f.id for f in frames}
        slots = []
        for f in frames:
            self._tick += 1
            slot = self.slot_of.get(f.id)
            if slot is None:
                slot = self._alloc(protect=batch_ids)
            if not self._fresh("slot", f):
                self._upload(f, slot)
                self.slot_of[f.id] = slot
                self._made[("slot", f.id)] = (f, f.version)
            self._use_tick[f.id] = self._tick
            slots.append(slot)
        return slots

    def covisibility_maps(self, frames) -> list[torch.Tensor]:
        """Each frame's stride-2 copy, uploading any not resident or stale."""
        stale = [f for f in frames if not self._fresh("stride2", f)]
        if stale:
            for f, t in zip(stale, self._upload_stride2(stale)):
                self.stride2[f.id] = t
                self._made[("stride2", f.id)] = (f, f.version)
        return [self.stride2[f.id] for f in frames]

    def release(self, fid: int):
        """Free both kinds of copy of frame ``fid``."""
        self._free_slot(fid)
        self.stride2.pop(fid, None)
        self._made.pop(("stride2", fid), None)

    # ------------------------------------------------------------------
    def _free_slot(self, fid: int):
        self.slot_of.pop(fid, None)
        self._use_tick.pop(fid, None)
        self._made.pop(("slot", fid), None)

    def _alloc(self, protect) -> int:
        used = set(self.slot_of.values())
        for s in range(self.capacity):
            if s not in used:
                return s
        # evict the least-recently-used unprotected frame
        victims = [fid for fid in self.slot_of if fid not in protect]
        if not victims:
            raise RuntimeError(
                f"DeviceFramePool capacity {self.capacity} smaller than one "
                f"match batch")
        victim = min(victims, key=lambda fid: self._use_tick.get(fid, 0))
        slot = self.slot_of[victim]
        self._free_slot(victim)
        return slot

    def _upload(self, frame, slot: int):
        """One frame's maps into ``slot`` on the current stream, packed in
        ``_pool_update``'s layout straight into the staging buffer."""
        profiler.count("launch/pool_upload")
        hw = frame.H * frame.W
        cuda = self.device.type == "cuda"
        st = staging(self.device, "fused_slot") if cuda else None
        packed = st.host(6 * hw) if cuda else torch.empty(6 * hw, dtype=torch.uint8)
        host = packed.numpy()
        host[:hw] = np.clip(np.round(frame.gray), 0, 255).reshape(-1)
        host[hw:3 * hw].view("<u2")[:] = np.clip(np.round(frame.depth * 1e4), 0, 65535).reshape(-1)
        host[3 * hw:].view(np.int8)[:] = np.clip(np.round(frame.normals * 127.0),
                                                 -127, 127).reshape(-1)
        if cuda:
            packed = packed.to(self.device, non_blocking=True)
            st.copied(torch.cuda.current_stream(self.device))
        _pool_update(self.gray, self.depth, self.normals, packed, slot)

    def _upload_stride2(self, frames) -> list[torch.Tensor]:
        """Each frame's packed stride-2 maps in a device tensor of its own,
        from one staging buffer, enqueued on the side stream."""
        cov = covisibility_cuda
        sizes = [cov.POINT_BYTES * cov.n_points(f) for f in frames]
        st = staging(self.device, "covisibility_copy")
        buf = st.host(sum(sizes))
        stream = side_stream(self.device)
        out, a = [], 0
        with torch.cuda.stream(stream):
            for f, n in zip(frames, sizes):
                cov.pack_maps(f, buf[a:a + n].numpy())
                out.append(buf[a:a + n].to(stream.device, non_blocking=True))
                a += n
            st.copied(stream)
        return out
