"""Two-view relative pose estimation (BASELINE config 2): Hamming matching +
essential-matrix LO-RANSAC + cheirality pose recovery + manifold polish."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinyslam.config import MatcherConfig, RansacConfig
from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.homography import (
    ransac_homography,
    recover_pose_homography,
)
from tinyslam.geometry.ransac import (
    ransac_essential,
    recover_pose,
    refine_relative_pose,
)
from tinyslam.ops.hamming import match_descriptors
from tinyslam.types import Features


class TwoViewEstimator:
    def __init__(
        self,
        camera: PinholeCamera,
        matcher: MatcherConfig = MatcherConfig(),
        ransac: RansacConfig = RansacConfig(),
    ):
        self.camera = camera
        self.matcher = matcher
        self.ransac = ransac

    def estimate(self, fa: Features, fb: Features, key=None) -> dict:
        """Relative pose of frame b wrt frame a: X_b = R X_a + t, |t| = 1.

        Returns dict with R, t, matches (idx_b per a-feature), match_valid,
        inliers, num_inliers, points (triangulated, frame-a coords).
        """
        key = jax.random.PRNGKey(0) if key is None else key
        m = match_descriptors(
            fa.desc, fa.valid, fb.desc, fb.valid,
            max_distance=self.matcher.max_distance,
            ratio=self.matcher.ratio,
            cross_check=self.matcher.cross_check,
        )
        x1 = self.camera.normalize(fa.xy)
        x2 = self.camera.normalize(fb.xy[m["idx_b"]])
        key_e, key_h = jax.random.split(key)
        if self.ransac.sample_size == 5:
            from tinyslam.geometry.fivepoint import ransac_essential_5pt

            res_e = ransac_essential_5pt(
                key_e, x1, x2, m["valid"],
                inlier_threshold=self.ransac.inlier_threshold,
                num_hypotheses=self.ransac.num_hypotheses // 4,
                refine_iters=self.ransac.refine_iters,
            )
        else:
            res_e = ransac_essential(
                key_e, x1, x2, m["valid"],
                inlier_threshold=self.ransac.inlier_threshold,
                num_hypotheses=self.ransac.num_hypotheses,
                sample_size=self.ransac.sample_size,
                refine_iters=self.ransac.refine_iters,
            )
        res_h = ransac_homography(
            key_h, x1, x2, m["valid"],
            inlier_threshold=self.ransac.inlier_threshold,
            num_hypotheses=self.ransac.num_hypotheses,
        )
        # Model selection (ORB-SLAM's rule): a quasi-planar scene makes E
        # degenerate; when the homography explains a comparable share of the
        # matches, trust the H decomposition instead.
        s_e = int(res_e["num_inliers"])
        s_h = int(res_h["num_inliers"])
        use_h = s_h / max(s_h + s_e, 1) > 0.45
        if use_h:
            pose = recover_pose_homography(res_h["H"], x1, x2, res_h["inliers"])
            R, t = pose["R"], pose["t"]
            inliers = res_h["inliers"]
            num_inliers = res_h["num_inliers"]
        else:
            pose = recover_pose(res_e["E"], x1, x2, res_e["inliers"])
            R, t = refine_relative_pose(
                pose["R"], pose["t"], x1, x2, res_e["inliers"],
                inlier_threshold=self.ransac.inlier_threshold,
            )
            inliers = res_e["inliers"]
            num_inliers = res_e["num_inliers"]
        return {
            "R": R,
            "t": t,
            "matches": m["idx_b"],
            "match_valid": m["valid"],
            "inliers": inliers & pose["good"],
            "num_inliers": num_inliers,
            "points": pose["points"],
            "model": "H" if use_h else "E",
        }
