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
                device resolution, the span profiler, pose and mesh metrics,
                meshing and mesh files
- ``ops``       hash-grid encoder and its two CUDA kernels, occupancy
                sampling, SH encoding; the tracker's depth pipeline, RANSAC,
                and the fused corres and match + BA programs; the rasterizer
- ``models``    the Neural Object Field networks, the corner matcher
- ``nof``       NOF rendering, losses, the training step, the runner, the
                texture bake
- ``tracking``  Frame, the device frame pool, correspondences, bundle
                adjustment and the keyframe pool (Bundler)
- ``io``        scene bounds, the PNG and baseline-JPEG codecs, OpenCV's
                resize and erosion in numpy, the YCBInEOAT and HO3D readers,
                the mask segmenter
- ``viz``       pose overlays, the point-splat mesh preview, the dashboard
- ``pipeline``  ``BundleSdf`` (tracking, the NOF rounds, the dashboard, the
                offline global refinement) and the artifact trail
- ``entry``     ``build_nof`` (the online-budget NOF), ``build_tracker``
                (tracking only), ``build_pipeline`` (tracking + NOF) and
                ``run_global_refine``
- ``scripts``   the user's commands: ``run_custom`` (modes run_video,
                global_refine, draw_pose), ``run_ho3d``, ``benchmark_ho3d``;
                run as ``python3 -m bundlesdf_tpu_torch.scripts.<name>``
- ``parallel``  the multi-process runtime on ``torch.distributed``
                (``init_multihost``, meshes and their collectives), the
                data-parallel and table-sharded NOF step, the sharded BA
"""

__version__ = "0.1.0"
