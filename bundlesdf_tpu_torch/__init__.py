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
- ``utils``     SE(3) maps and rigid alignment, camera and ray geometry,
                device resolution, the span profiler, pose metrics
- ``ops``       hash-grid encoder and its two CUDA kernels, occupancy
                sampling, SH encoding; the tracker's depth pipeline, RANSAC,
                and the fused corres and match + BA programs
- ``models``    the Neural Object Field networks, the corner matcher
- ``nof``       NOF rendering, losses and the training step
- ``tracking``  Frame, the device frame pool, correspondences, bundle
                adjustment and the keyframe pool (Bundler)
- ``pipeline``  ``BundleSdf``, tracking only so far
- ``entry``     ``build_nof`` (the online-budget NOF) and ``build_tracker``
                (the tracking-only ``BundleSdf``), used by ``chip_smoke.py``
"""

__version__ = "0.1.0"
