"""LoFTR's training step FLOPs for one pair of H x W images with the fine
branch at K windows, counted as ``torch.utils.flop_counter`` counts a
forward and its backward: the forward of ``loftr_costs.pair_flops``, and
twice each of its products again in the backward (the gradient of each
operand), but for the two products whose other operand needs no gradient:
the first convolution's input (the images) and the fine expectation's
grid, each once."""
from __future__ import annotations

from .loftr_costs import _conv_out, pair_flops


def step_flops(w: dict, H: int, W: int, K: int) -> int:
    """One pair's forward and backward; ``w`` takes the keys of
    ``reference/loftr.py::CVPR_DS``."""
    conv1 = 2 * w["initial_dim"] * 7 * 7 * _conv_out(H, 7, 2) * _conv_out(W, 7, 2)
    grid = 2 * K * w["window"] ** 2 * 2
    return 3 * pair_flops(w, H, W, K) - 2 * conv1 - grid
