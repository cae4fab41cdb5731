"""Device resolution for the port's entry points.

``None`` means the CUDA card.  Without one, an entry point raises instead of
quietly running on the CPU; tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bundlesdf_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
