"""Assembled systems: the user-facing model zoo.

- OrbFrontend (re-export)  — feature extraction only (BASELINE config 1).
- TwoViewEstimator         — matching + relative pose (config 2).
- VisualOdometry           — host-driven tracking + keyframes + local BA
                             (configs 3-4; reference loop for tests/debug).
- DeviceVO                 — the FLAGSHIP tracker: the same loop compiled
                             into chunked lax.scan dispatches (one readback
                             per chunk instead of ~12 per frame).
- Slam / DeviceSlam        — VO + pose-graph loop closure (config 5), over
                             the host / device tracker respectively.
"""

from tinyslam.frontend.orb import OrbFrontend  # noqa: F401
from tinyslam.models.two_view import TwoViewEstimator  # noqa: F401
from tinyslam.models.vo import VisualOdometry, MapState  # noqa: F401
from tinyslam.models.vo_device import DeviceVO, VOState  # noqa: F401
from tinyslam.models.slam import DeviceSlam, Slam  # noqa: F401
