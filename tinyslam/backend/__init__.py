"""Optimization back-end: Schur-complement Levenberg-Marquardt bundle
adjustment and pose-graph optimization.

Absent from the reference (unchecked roadmap, reference README.md:53-57);
built to BASELINE configs 4-5.  Fixed-shape design (SURVEY §7): per-landmark
3x3 and per-pose 6x6 dense blocks, vmapped landmark elimination, the reduced
camera system as one dense Cholesky solve — all einsums.  Landmark blocks
shard across the device mesh; the reduced system is psum-reduced across it
(see parallel.dist_ba).
"""

from tinyslam.backend.residuals import reprojection_residuals  # noqa: F401
from tinyslam.backend.ba import bundle_adjust  # noqa: F401
from tinyslam.backend.pose_graph import optimize_pose_graph  # noqa: F401
