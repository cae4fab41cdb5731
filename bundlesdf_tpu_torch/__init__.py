"""bundlesdf_tpu_torch — the PyTorch/CUDA port of ``bundlesdf_tpu``.

The JAX package ``bundlesdf_tpu`` stays the reference; this package grows
beside it slice by slice and mirrors its layout and function names, so each
function here names its JAX counterpart.  It imports ``torch`` and never
``jax`` or anything of ``bundlesdf_tpu``.

Every TPU (Pallas) kernel of the JAX package becomes a hand-written Hopper
kernel under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use and
bound with ``ctypes`` (``ops/_cuda_lib.py``).  Each kernel's wrapper runs its
plain PyTorch version for a CPU tensor and launches the kernel, or raises,
for a CUDA tensor.

Subpackages
-----------
- ``utils``   SE(3) exp map, ray/box intersection, device resolution
- ``ops``     hash-grid encoder and its two CUDA kernels, occupancy
              sampling, SH encoding
- ``models``  the Neural Object Field networks
- ``nof``     NOF rendering, losses and the training step
- ``entry``   the online-budget NOF build used by ``chip_smoke.py``
"""

__version__ = "0.1.0"
