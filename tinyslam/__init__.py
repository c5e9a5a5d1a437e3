"""tinyslam — an accelerator-native visual SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``ccaven/tinyslam`` reference (Rust + WGSL, wgpu/Vulkan).  The reference
implements an ORB feature-extraction front-end (reference src/orb.rs:1-589
and src/shaders/*.wgsl); its README roadmap (reference README.md:53-57)
plus BASELINE.json define the full intended pipeline, which this framework
implements completely:

- ``ops``       — device kernels: grayscale, image pyramid, separable Gaussian
                  blur, FAST-16 corner scoring (bitwise streak trick), top-k
                  compaction/NMS, steered BRIEF, matmul Hamming matching.
- ``frontend``  — the ORB front-end pipeline (jitted end-to-end).
- ``geometry``  — SE3/SO3, pinhole cameras, essential-matrix estimation,
                  RANSAC, triangulation, PnP.
- ``backend``   — Schur-complement Levenberg–Marquardt bundle adjustment and
                  pose-graph optimization.
- ``parallel``  — device-mesh sharding: frame data parallelism, landmark-block
                  sharding for distributed BA (psum over the mesh), multi-host
                  helpers.
- ``models``    — assembled systems: OrbFrontend, VisualOdometry, Slam.
- ``data``      — TUM RGB-D / EuRoC loaders (native C++ PNG decode),
                  synthetic scene generators.
- ``utils``     — ATE/RPE evaluation, metrics registry, profiling,
                  checkpointing.

Design stance (see SURVEY.md §7): pure functions over fixed-shape pytrees,
jitted end-to-end; dynamic feature counts are fixed-capacity arrays + valid
masks; compaction by deterministic top-k instead of device atomics; matching
and BA shaped as dense matrix products.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# A DEFAULT-precision f32 matmul may run with reduced-precision multiplies
# (TF32 on the GPU).  That is fine for the front-end (descriptors tolerate
# bit noise; Hamming matching is int8) but it poisons the GEOMETRY path —
# triangulation, PnP Gauss-Newton, the BA Schur solve — where a short
# mantissa costs trajectory accuracy.  Accuracy is a product target
# (BASELINE: ATE <= 0.05 m), so float32 is the framework default; the few
# throughput-critical front-end matmuls opt back into DEFAULT explicitly
# (ops/brief.py).  Override with TINYSLAM_MATMUL_PRECISION=default to
# benchmark the difference.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("TINYSLAM_MATMUL_PRECISION", "float32"),
)

from tinyslam.config import (  # noqa: F401
    FrontendConfig,
    MatcherConfig,
    RansacConfig,
    BAConfig,
    VOConfig,
    SlamConfig,
)
from tinyslam.types import Features  # noqa: F401
