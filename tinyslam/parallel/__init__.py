"""Multi-chip / multi-host parallelism (SURVEY §2d).

The reference is single-process, single-GPU (verified absence of any
distributed code, SURVEY §2d); this layer is designed for a device mesh from
BASELINE config 5:

- ``mesh``        — device mesh construction (frame x landmark axes) and
                    multi-host init helpers.
- ``frontend_dp`` — frame data parallelism: batched ORB extraction sharded
                    over the `frame` axis.
- ``dist_ba``     — landmark-sharded bundle adjustment under shard_map:
                    per-shard normal blocks, Schur contributions psum-ed
                    over the mesh, replicated reduced-camera solve, shard-local
                    landmark back-substitution.
- ``dist_pose_graph`` — edge-sharded pose-graph optimization: per-shard
                    normal-equation assembly, one psum per GN iteration,
                    replicated solve (trajectory-scaling / SP analog).
"""

from tinyslam.parallel.mesh import make_mesh, initialize_multihost  # noqa: F401

# The remaining exports are lazy (PEP 562): ``initialize_multihost`` must be
# callable BEFORE the XLA backend initializes (jax.distributed.initialize
# refuses otherwise), and the kernel modules build jnp constants at import.
_LAZY = {
    "extract_features_batch": "tinyslam.parallel.frontend_dp",
    "bundle_adjust_sharded": "tinyslam.parallel.dist_ba",
    "optimize_pose_graph_sharded": "tinyslam.parallel.dist_pose_graph",
}

__all__ = ["make_mesh", "initialize_multihost", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
