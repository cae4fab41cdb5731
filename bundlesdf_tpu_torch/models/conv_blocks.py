"""The float32 convolution blocks that the port's CNNs share: LoFTR's
ResNet-FPN (``models/loftr.py``, ``models/loftr_train.py``) and XMem's key
and value encoders (``models/xmem.py``).

- ``FrozenBatchNorm2d``: BatchNorm at its running statistics, in
  ``train()`` mode too;
- ``conv``: a bias-free convolution padded to keep the size at stride 1;
- ``BasicBlock``: ResNet-18/34's block (two 3 x 3 convolutions, the stride
  on the first, a 1 x 1 projection where the stride is not 1);
- ``Bottleneck``: ResNet-50's block (torchvision's v1.5: 1 x 1, 3 x 3 with
  the stride, 1 x 1 to 4 x the planes, a 1 x 1 projection where the stride
  or the width changes);
- ``without_cudnn``: PyTorch's own convolutions instead of cuDNN's.

Submodules carry torchvision's state-dict names (``conv1``, ``bn1``, ...,
``downsample.0``, ``downsample.1``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalizes with its running statistics, in
    ``train()`` mode too (flax ``BatchNorm(use_running_average=True)``):
    batch statistics are never used or accumulated.

    The JAX trainer differentiates those statistics like any weight (they
    sit in the variables it hands to optax), so when they require grad
    (``models/loftr_train.py``) the layer is written out as flax computes
    it, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, which autograd
    differentiates with respect to them."""

    def forward(self, x):
        if self.running_mean.requires_grad or self.running_var.requires_grad:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = None if stride == 1 else nn.Sequential(
            conv(in_planes, planes, 1, stride), FrozenBatchNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv(in_planes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = conv(planes, out, 1)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None if stride == 1 and in_planes == out else nn.Sequential(
            conv(in_planes, out, 1, stride), FrozenBatchNorm2d(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def res_layer(block, in_planes: int, planes: int, n: int, stride: int) -> nn.Sequential:
    """A ResNet stage of ``n`` blocks, the stride on its first."""
    blocks = [block(in_planes, planes, stride)]
    width = planes * getattr(block, "expansion", 1)
    blocks += [block(width, planes, 1) for _ in range(n - 1)]
    return nn.Sequential(*blocks)


@contextlib.contextmanager
def without_cudnn():
    """PyTorch's own convolutions (im2col + cuBLAS GEMM) instead of cuDNN's.
    For these f32 convolutions (TF32 off) cuDNN picks FFT tiling, tens of
    thousands of small complex GEMMs: on the H100 a 400 x 400 pair took
    323-485 ms and 21.6 GB on cuDNN against 22-23 ms and 1.4 GB here
    (chip_smoke.py loftr_parity, PERF.md §6)."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev
