"""Device-resident frame-map pool for the fused correspondence path (port of
``bundlesdf_tpu/tracking/device_pool.py``).

The reference keeps every frame's maps on the GPU while the frame lives
(Frame.cpp:80-138; CUDACache for BA).  This pool is that residency: one
packed upload per frame (gray u8 + depth u16 at 0.1 mm + normals i8, 6
bytes a pixel), decoded on the device into float32 pools, with LRU slot
reuse bounded by ``capacity``.  The upload goes through one pinned host
buffer with ``non_blocking``; the buffer is rewritten only after the
previous copy out of it has finished.

Quantization: depth 0.1 mm steps (sensor noise ~1 mm; RANSAC inlier_dist
5 mm), normals 1/127 (~0.5 deg; the normal gate is 30 deg).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiler
from ..utils.device import resolve_device


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
    def __init__(self, H: int, W: int, capacity: int = 64, device=None):
        self.device = resolve_device(device)
        self.H, self.W, self.capacity = H, W, capacity
        f32 = dict(dtype=torch.float32, device=self.device)
        self.gray = torch.zeros((capacity, H, W), **f32)
        self.depth = torch.zeros((capacity, H, W), **f32)
        self.normals = torch.zeros((capacity, H, W, 3), **f32)
        self.K = None  # (3, 3) intrinsics on the device, set by the owner
        self.slot_of: dict[int, int] = {}
        self._use_tick: dict[int, int] = {}
        self._tick = 0
        self._staging = None  # pinned host buffer of one packed frame
        self._staged = None   # event: the last copy out of it has finished

    # ------------------------------------------------------------------
    def ensure(self, frames) -> list[int]:
        """Return pool slots for ``frames``, uploading any not resident.
        Frames in this batch are protected from eviction."""
        batch_ids = {f.id for f in frames}
        slots = []
        for f in frames:
            self._tick += 1
            if f.id in self.slot_of:
                self._use_tick[f.id] = self._tick
                slots.append(self.slot_of[f.id])
                continue
            slot = self._alloc(protect=batch_ids)
            self._upload(f, slot)
            self.slot_of[f.id] = slot
            self._use_tick[f.id] = self._tick
            slots.append(slot)
        return slots

    def release(self, fid: int):
        self.slot_of.pop(fid, None)
        self._use_tick.pop(fid, None)

    # ------------------------------------------------------------------
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
        self.release(victim)
        return slot

    @staticmethod
    def pack(frame) -> np.ndarray:
        """The frame's 6-byte-a-pixel upload buffer (u8)."""
        gray_u8 = np.clip(np.round(frame.gray), 0, 255).astype(np.uint8)
        depth_u16 = np.clip(np.round(frame.depth * 1e4), 0, 65535).astype("<u2")
        norm_i8 = np.clip(np.round(frame.normals * 127.0), -127, 127).astype(np.int8)
        return np.concatenate([
            gray_u8.reshape(-1),
            depth_u16.view(np.uint8).reshape(-1),
            norm_i8.view(np.uint8).reshape(-1),
        ])

    def _upload(self, frame, slot: int):
        profiler.count("launch/pool_upload")
        packed = torch.from_numpy(self.pack(frame))
        if self.device.type == "cuda":
            if self._staging is None:
                self._staging = torch.empty(packed.shape, dtype=torch.uint8,
                                            pin_memory=True)
                self._staged = torch.cuda.Event()
            self._staged.synchronize()
            self._staging.copy_(packed)
            packed = self._staging.to(self.device, non_blocking=True)
            self._staged.record()
        _pool_update(self.gray, self.depth, self.normals, packed, slot)
