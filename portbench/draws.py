"""The random draws the benchmark hands the program, made from ``--seed``:
each NOF step's batch rows and sampling jitter (through the runner's
``train_draws`` hook) and each frame's RANSAC uniforms (through the
tracker's ``ransac_draws`` hook).  The plain reference is given the same
draws, so both sides train on the same rows at the same sample points."""
from __future__ import annotations

import torch


def mix(*words: int) -> int:
    """A 63-bit generator seed from whole numbers (splitmix64 rounds)."""
    z = 0x243F6A8885A308D3
    for w in words:
        z = (z ^ (int(w) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z & 0x7FFFFFFFFFFFFFFF


class NofDraws:
    """``(step, n_rays) -> (batch_idx, (occ, band, fallback, importance))``
    for a NOF config: ``N_rand`` rows uniform in ``[0, n_rays)`` and the
    render's jitter uniforms, drawn on ``device`` from one generator seeded
    from the run's seed.  ``record(True)`` keeps a copy of every step's
    draws until ``record(False)``, which returns them."""

    def __init__(self, cfg: dict, seed: int, device):
        self.n = int(cfg["N_rand"])
        self.widths = (int(cfg["N_samples"]), int(cfg["N_samples_around_depth"]),
                       int(cfg["N_samples_around_depth"]), int(cfg.get("N_importance", 0)))
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(mix(seed, 1))
        self.calls = 0
        self._log = None

    def __call__(self, step: int, n_rays: int):
        idx = torch.randint(0, max(int(n_rays), 1), (self.n,), generator=self.gen,
                            device=self.device)
        u = tuple(torch.rand((self.n, k), generator=self.gen, device=self.device)
                  if k else None for k in self.widths)
        self.calls += 1
        if self._log is not None:
            self._log.append((int(n_rays), idx.clone(),
                              tuple(None if x is None else x.clone() for x in u)))
        return idx, u

    def record(self, on: bool):
        """Start keeping the draws (``on``), or stop and return those kept:
        a list of (n_rays, batch_idx, (occ, band, fallback, importance))."""
        if on:
            self._log = []
            return None
        log, self._log = self._log, None
        return log


def ransac_draws(seed: int):
    """The tracker's RANSAC draw source: ``(frame_id, shape) -> uniforms``
    from a CPU generator seeded from the run's seed and the frame id (the
    tracker moves them to its device)."""

    def source(frame_id: int, shape: tuple):
        gen = torch.Generator().manual_seed(mix(seed, 2, frame_id))
        return torch.rand(shape, generator=gen)

    return source
