"""Multi-view geometry: SE3/SO3 Lie groups, pinhole cameras, essential-matrix
two-view estimation, batched RANSAC, triangulation, PnP pose tracking.

The reference has none of this — it is unchecked roadmap (reference
README.md:53-57); the design follows standard ORB-SLAM-class structure
(SURVEY.md §1 note), shaped for XLA: every solver is batched, fixed-shape,
fixed-iteration and jit-compatible (no data-dependent control flow —
RANSAC hypotheses are one batched SVD, not a loop).
"""

from tinyslam.geometry.se3 import (  # noqa: F401
    so3_exp,
    so3_log,
    so3_hat,
    se3_exp,
    se3_log,
    se3_identity,
    se3_compose,
    se3_inverse,
    se3_apply,
)
from tinyslam.geometry.camera import PinholeCamera  # noqa: F401
from tinyslam.geometry.epipolar import (  # noqa: F401
    eight_point_essential,
    sampson_error,
    decompose_essential,
    triangulate,
)
from tinyslam.geometry.ransac import (  # noqa: F401
    ransac_essential,
    recover_pose,
    refine_relative_pose,
)
from tinyslam.geometry.pnp import pnp_refine  # noqa: F401
