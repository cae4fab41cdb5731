"""A fault planted in the program for the XMem cell's checks, and what it
takes to see it.

``unpotentiated`` makes each prototype keep its candidate's value: the
consolidation's readout of the candidates' values with the prototype keys
left out.  The next step's reference starts from the program's state and
reads the same store, so only ``memory_gap`` can fail it.  It moves a value
only as far as the candidates' affinity spreads beyond the prototype
itself; ``soft_keys`` gives weights under which it spreads."""
import contextlib

from bundlesdf_tpu_torch.models import xmem


@contextlib.contextmanager
def unpotentiated():
    """Patch ``Memory.consolidate`` while open; yields the list that gets
    each consolidation's share ``|pv - cv[idx]| / |pv|``, what the fault
    takes away."""
    merge = xmem.Memory.consolidate
    shares = []

    def consolidate(mem):
        hw, t_min = mem.hw, mem.cfg.min_mid_term_frames
        cand = mem.value[:, mem.n_lt + hw:mem.size - t_min * hw + hw].clone()
        idx, evicted = merge(mem)
        protos = mem.value[:, mem.n_lt - len(idx):mem.n_lt]
        kept = cand[:, idx]
        shares.append(float((protos - kept).norm() / protos.norm()))
        protos.copy_(kept)
        return idx, evicted

    xmem.Memory.consolidate = consolidate
    try:
        yield shares
    finally:
        xmem.Memory.consolidate = merge


def soft_keys(sd: dict, scale: float = 0.1) -> dict:
    """``sd`` with the key projection scaled by ``scale`` and a shrinkage
    of 1: the keys lie close together, so a consolidation's affinity
    spreads over the candidates."""
    sd = dict(sd)
    sd["key_proj.key_proj.weight"] = sd["key_proj.key_proj.weight"] * scale
    sd["key_proj.d_proj.weight"] = sd["key_proj.d_proj.weight"] * 0
    sd["key_proj.d_proj.bias"] = sd["key_proj.d_proj.bias"] * 0
    return sd
