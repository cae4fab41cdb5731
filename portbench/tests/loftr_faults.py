"""Faults planted in the program for the LoFTR cell's checks: each is
applied with ``monkeypatch.setattr(*fault)`` (or by hand, and undone) and
has to fail the check named beside it."""
import numpy as np
import torch

from bundlesdf_tpu_torch.io import imgproc
from bundlesdf_tpu_torch.models import loftr as lt


class PassThrough(torch.nn.Module):
    """An encoder layer left out: its input goes on unchanged."""

    def forward(self, x, source):
        return x


def drop_last_coarse_layer(module) -> None:
    """The engine's last coarse (cross) layer left out: ``conf_gap``."""
    layers = module.loftr_coarse.layers
    layers[len(layers) - 1] = PassThrough()


def shifted_warp(img, M, dsize, _warp=imgproc.warp_perspective):
    """The device warp one pixel off in x: ``warp_gap``."""
    return _warp(img, np.array([[1, 0, 1], [0, 1, 0], [0, 0, 1]]) @ M, dsize)


def no_border(conf, Hc, Wc, thr, border_rm, K, _select=lt.coarse_match_fixed):
    """The selection with its border removal left out: ``topk_mismatch``."""
    return _select(conf, Hc, Wc, thr, 0, K)


# (target, attribute, replacement), the check each fails
PATCHES = {"warp": ((imgproc, "warp_perspective", shifted_warp), "warp_gap"),
           "selection": ((lt, "coarse_match_fixed", no_border), "topk_mismatch")}
