"""Device resolution for the port's entry points, and the tracker's one
staging path from host to card.

``None`` means the CUDA card.  Without one, an entry point raises instead of
quietly running on the CPU; tests pass ``device="cpu"`` explicitly.  The
tracker's copies between host and card go through a ``Staging`` (one a
device and use) and its depth and covisibility kernels run on one side
stream a device, so that a frame never waits behind NOF work.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bundlesdf_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


class Staging:
    """A pinned host buffer, grown on demand, and the event that marks the
    last copy through it as finished: it is handed out only after that."""

    def __init__(self):
        self._buf = torch.empty(0, dtype=torch.uint8)
        self._done = torch.cuda.Event()    # made at its first record

    def host(self, nbytes: int) -> torch.Tensor:
        """The buffer's first ``nbytes`` (uint8), once it is free."""
        self.wait()
        if self._buf.numel() < nbytes:
            self._buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self._buf[:nbytes]

    def copied(self, stream: torch.cuda.Stream) -> None:
        """Mark the copies through the buffer enqueued so far on ``stream``."""
        self._done.record(stream)

    def wait(self) -> None:
        """Block until the copies marked last have finished (none: return)."""
        self._done.synchronize()


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _staging(index: int, use: str) -> Staging:
    return Staging()


def side_stream(device) -> torch.cuda.Stream:
    """The tracker's side stream on the CUDA ``device``."""
    return _side_stream(_index(device))


def staging(device, use: str) -> Staging:
    """The staging buffer of ``use`` on the CUDA ``device``."""
    return _staging(_index(device), use)
