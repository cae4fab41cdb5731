"""First-frame / per-frame object segmentation providers.

``Segmenter`` is the port of ``bundlesdf_tpu/io/segmentation.py:17-35``.
The reference ships a thin stub that reads precomputed mask PNGs (XMem is
excluded for license reasons, readme.md:67; segmentation_utils.py:13-18).
Same contract here: ``Segmenter.run(color_file, ...)`` returns the mask for
that frame from a sibling ``masks/`` directory (or ``mask_dir``), so any
external video segmenter can drop its outputs there.

``XmemSegmenter`` runs XMem itself on the card, frame by frame, from the
first frame's mask (``entry.build_segmenter``; ``BundleSdf(segmenter=...)``
takes each frame's mask from it).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..models import xmem
from ..utils.device import staging
from ..utils.profiler import span
from .imgproc import resize_nearest
from .imread import imread_unchanged


class Segmenter:
    """Reads precomputed masks (reference segmentation_utils.Segmenter)."""

    def __init__(self, mask_dir: str | None = None):
        self.mask_dir = mask_dir

    def run(self, color_file: str, out_size=None):
        """The mask of ``color_file``'s frame, read as ``cv2.imread(path,
        -1)`` reads it (by its content, whatever its name): 0/255 uint8 for
        a file of several channels, the file's values for a gray one;
        resized to ``out_size`` (W, H) by nearest neighbour when given."""
        if self.mask_dir is not None:
            path = os.path.join(self.mask_dir, os.path.basename(color_file))
        else:
            path = color_file.replace("rgb", "masks")
        mask = imread_unchanged(path)
        if mask is None:
            raise FileNotFoundError(f"mask not found: {path}")
        if mask.ndim == 3:
            mask = (mask.sum(axis=-1) > 0).astype(np.uint8) * 255
        if out_size is not None:
            mask = resize_nearest(mask, *out_size)
        return mask


class XmemSegmenter:
    """XMem (``models/xmem.py``) as the pipeline's segmenter: ``step(color,
    mask=None)`` returns each frame's mask from the first frame's, which the
    first step must be given (a mask given later replaces the prediction and
    makes that frame a memory frame, as in the upstream's
    ``InferenceCore.step``).  ``color``: (H, W, 3) uint8 RGB on the host, as
    the readers give it; the mask: (H, W) uint8, 255 on the object, as
    ``Frame`` takes it.  ``reset()`` forgets the video.

    On the card the frame (and a given mask) go up through the device's
    ``xmem`` staging buffer (``utils/device.py``), the tracker's one staging
    path, and the mask comes back through it: the span ``xmem/readback``
    waits for the device once a frame."""

    def __init__(self, net, cfg, device):
        self.cfg = cfg
        self.device = device
        self.core = xmem.XmemProcessor(net, cfg)

    def reset(self) -> None:
        self.core.reset()

    def step(self, color, mask=None) -> np.ndarray:
        color = np.asarray(color)
        H, W = color.shape[:2]
        with span("xmem/step"):
            img, given = self._upload(color, mask)
            x, pad = xmem.prepare_frame(img, self.cfg.size)
            m = None if given is None else xmem.prepare_mask(given, self.cfg.size)[0]
            prob = xmem.unpad(self.core.step(x, m), pad)
            with torch.inference_mode():
                if tuple(prob.shape[-2:]) != (H, W):
                    prob = F.interpolate(prob[None], size=(H, W), mode="bilinear",
                                         align_corners=False)[0]
                fg = prob[1] > prob[0]
            with span("xmem/readback"):
                out = self._readback(fg)
            self.core.account_read_time()
        return out

    def _upload(self, color: np.ndarray, mask) -> tuple:
        H, W = color.shape[:2]
        if self.device.type != "cuda":
            img = torch.from_numpy(np.ascontiguousarray(color, dtype=np.uint8))
            return img, None if mask is None else torch.from_numpy(np.asarray(mask) > 0)
        hw = H * W
        st = staging(self.device, "xmem")
        buf = st.host(5 * hw)     # the frame, a given mask, the mask read back
        host = buf.numpy()
        np.copyto(host[:3 * hw].reshape(H, W, 3), color, casting="unsafe")
        n = 3 * hw
        if mask is not None:
            np.greater(mask, 0, out=host[n:n + hw].reshape(H, W).view(np.bool_))
            n += hw
        on_card = buf[:n].to(self.device, non_blocking=True)
        img = on_card[:3 * hw].view(H, W, 3)
        given = None if mask is None else on_card[3 * hw:].view(torch.bool).view(H, W)
        return img, given

    def _readback(self, fg: torch.Tensor) -> np.ndarray:
        H, W = fg.shape
        if self.device.type != "cuda":
            return fg.numpy().astype(np.uint8) * 255
        hw = H * W
        st = staging(self.device, "xmem")
        buf = st.host(5 * hw)
        buf[4 * hw:].copy_(fg.reshape(-1).view(torch.uint8), non_blocking=True)
        st.copied(torch.cuda.current_stream(self.device))
        st.wait()
        return buf[4 * hw:].numpy().reshape(H, W) * np.uint8(255)
