"""bundlefusion_tpu — real-time RGB-D SLAM / dense reconstruction in JAX.

A from-scratch JAX/XLA re-design of the BundleFusion pipeline
(Dai et al., TOG 2017; reference C++/CUDA implementation surveyed in
SURVEY.md). The compute path is jitted XLA; the host runtime (IO,
orchestration, scheduling) is Python/C++.

Subpackages
-----------
- ``geometry``: se(3)/so(3) Lie math, Kabsch alignment, camera models.
- ``io``: .sens / TUM RGB-D readers, PLY export, synthetic scene rendering.
- ``ops``: image ops, SIFT-style feature detection, descriptor matching,
  the match-filter cascade.
- ``tsdf``: block-sparse TSDF voxel map: allocate, integrate, de-integrate,
  raycast, marching cubes.
- ``solver``: sparse + dense bundle-adjustment Gauss-Newton/PCG.
- ``pipeline``: online orchestration — submaps, keyframes, trajectory
  management, re-integration scheduling.
- ``parallel``: multi-chip sharding of matching and global BA.
- ``utils``: timing, metrics (ATE RMSE), logging.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry (poses, Kabsch, small solves) dominates accuracy: every float32
# matmul runs at full precision (never TF32 on the GPU). Throughput-critical
# big matmuls (descriptor matching) opt back into bf16 at the call site.
_jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir(environ) -> str:
    """Persistent compilation cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``.jax_cache`` in the checkout.
    A fixed path: the path is part of what a cache hit needs."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir(_os.environ))

from bundlefusion_tpu.config import AppConfig, BundlingConfig  # noqa: F401,E402
