"""The import guard: a run of the port's benchmark may not load JAX or the
JAX package.  A module's top-level name (before the first dot) is compared
whole, so ``bundlesdf_tpu_torch`` passes while ``bundlesdf_tpu`` fails."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "bundlesdf_tpu")


def forbidden_modules(modules=None) -> list:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name
    is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
