"""The JAX package's native host library for the port's tests that hold the
port against it (``test_torch_texture.py``, ``test_torch_global.py``).

``bundlesdf_tpu.native`` builds ``libbundlesdf_host.so`` with cmake at first
use, in one build directory, and tries once a process.  Under pytest-xdist
every worker imports ``tests/test_native.py`` at collection, whose marker
calls ``native.available()``, so on a tree without the library the workers'
builds race in that directory and the losers keep "no library" for the
whole run.  ``require_native`` loads it again in such a process: under an
``fcntl`` lock on a file beside the library, so that one process at a time
builds, after the collection-time builds have ended.
"""
import fcntl
import os
import shutil

import pytest

from bundlesdf_tpu import native

_LOCK = os.path.join(os.path.dirname(native._LIB_PATH), ".build.lock")


def require_native():
    """The loaded ``bundlesdf_tpu.native`` module; fails the calling test,
    with the reason, when the library can be neither loaded nor built."""
    if native._lib is None:
        with open(_LOCK, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            native._tried = False
            if native._load() is None and not os.path.exists(native._LIB_PATH):
                # a build directory left unusable by the raced builds (or
                # configured from another path): build once more from scratch
                shutil.rmtree(os.path.join(os.path.dirname(native._LIB_PATH), "build"),
                              ignore_errors=True)
                native._tried = False
                native._load()
    if native._lib is None:
        pytest.fail(f"the native host library {native._LIB_PATH} could not be "
                    "loaded or built (cmake and ninja are needed; see the log "
                    "of bundlesdf_tpu.native._build)")
    return native
