"""Frozen configuration tree for the whole framework.

The reference exposes a single 4-field config (reference src/orb.rs:40-45:
image_size, max_features, hierarchy_depth, initial_threshold) plus one runtime
knob (set_threshold, orb.rs:585-589).  Here every subsystem gets a frozen
dataclass; the tree is hashable (usable as a jit static argument) and
round-trips to JSON.  The reference's one good config idea is kept: static
capacities chosen up front so every XLA shape is static (SURVEY.md §3.5).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _fromdict(cls: type, d: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, type) and dataclasses.is_dataclass(f.type)
        ):
            kwargs[f.name] = _fromdict(f.type, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str):
        return _fromdict(cls, json.loads(s))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FrontendConfig(_JsonMixin):
    """ORB front-end configuration.

    Mirrors the reference's OrbConfig (orb.rs:40-45) with the quirks fixed and
    additions for static shapes (per-level feature caps) and NMS.
    """

    height: int = 480
    width: int = 640
    num_levels: int = 4            # reference: hierarchy_depth, capped at 10 (orb.rs:67)
    threshold: float = 0.06        # FAST threshold on [0,1] intensities (orb.rs:44 initial_threshold)
    features_per_level: int = 512  # static top-k capacity per pyramid level
    streak_length: int = 9         # FAST-N contiguous-arc length; 9 = canonical ORB,
                                   # 12 = the reference's (misses 90-degree corners)
    border: int = 20               # >= ceil(13*sqrt(2)): rotated BRIEF reach.  The
                                   # reference uses 16 (fast.wgsl:77) which lets BRIEF
                                   # read out of bounds for |angle| near 45 deg — fixed here.
    blur_sigma: float = 2.0        # 7-tap Gaussian, as in canonical ORB
    nms: bool = True               # 3x3 non-max suppression (reference has none)
    interpolate_descriptors: bool = False  # nearest sampling, as reference brief.wgsl:57-60
    brief_bins: int = 16           # orientation bins for the matmul BRIEF
                                   # (0 = continuous-angle gather path).  ORB
                                   # itself quantizes to 30-degree bins (12);
                                   # 16 bins = 22.5 degrees, and the bin
                                   # count scales the dominant BRIEF matmul
                                   # (N, 1600) x (1600, bins*256) linearly —
                                   # 32 -> 16 halves it
    adaptive_threshold: bool = True  # feedback controller on the FAST threshold
    target_fill: float = 0.75      # desired detected/capacity ratio

    @property
    def max_features(self) -> int:
        return self.features_per_level * self.num_levels


@dataclass(frozen=True)
class MatcherConfig(_JsonMixin):
    """Hamming descriptor matcher (int8 sign-product formulation)."""

    max_distance: int = 64         # max Hamming distance (of 256) for a valid match
    ratio: float = 0.9             # Lowe ratio test threshold (best/second-best)
    cross_check: bool = True       # mutual nearest neighbour


@dataclass(frozen=True)
class RansacConfig(_JsonMixin):
    """Batched-hypothesis RANSAC for two-view geometry."""

    num_hypotheses: int = 512      # all hypotheses solved in one batched SVD
    sample_size: int = 5           # 5 = Nister minimal solver (geometry.fivepoint),
                                   # 8 = linear 8-point (geometry.epipolar)
    inlier_threshold: float = 2e-3 # Sampson distance in normalized image coords
    refine_iters: int = 3          # IRLS refinement rounds on inliers


@dataclass(frozen=True)
class BAConfig(_JsonMixin):
    """Schur-complement Levenberg–Marquardt local bundle adjustment."""

    max_keyframes: int = 10        # sliding window (BASELINE config 4)
    max_landmarks: int = 2048      # static landmark-block capacity
    max_iters: int = 6             # LM outer iterations.  More is NOT
                                   # better here: the window refits after
                                   # every keyframe, so per-insert LM only
                                   # needs to re-converge a warm solution
                                   # (measured: 10 iters tracks no better
                                   # than 6 and costs 1.3 ms/iter)
    damping_init: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.5
    huber_delta: float = 5.0       # pixels, robust loss
    cg_iters: int = 0              # 0 = dense Cholesky on the reduced camera system


@dataclass(frozen=True)
class VOConfig(_JsonMixin):
    """Frame-to-frame visual odometry loop."""

    max_map_points: int = 8192     # fixed-capacity landmark store
    pnp_iters: int = 8             # Gauss-Newton iterations for pose tracking
    track_radius_px: float = 20.0  # guided-matching radius around the
                                   # predicted projection during tracking;
                                   # must cover the prediction error of one
                                   # frame of unmodeled acceleration (fast
                                   # MAV yaw blows past a tight radius and
                                   # tracking starves before PnP even runs)
    pnp_inlier_px: float = 4.0     # reprojection inlier threshold (pixels)
    keyframe_min_inliers: int = 150    # below -> new keyframe.  Eager
                                       # cadence (ORB-SLAM-style): waiting
                                       # until ~60 leaves the map nearly
                                       # exhausted between keyframes, so
                                       # tracking rides the 20-inlier floor
                                       # (measured min inliers 3 vs 34 on
                                       # the orbit bench)
    keyframe_max_interval: int = 20    # frames
    keyframe_min_interval: int = 3     # min frames between keyframes: back-to-
                                       # back keyframes have ~zero baseline, so
                                       # triangulation rejects everything and
                                       # the map starves while the window
                                       # churns (ORB-SLAM has the same gate)
    keyframe_critical_inliers: int = 30  # below -> keyframe NOW, interval or not
    reloc_hypotheses: int = 512        # PnP-RANSAC hypotheses when tracking
                                       # is lost (absolute pose, no prior).
                                       # At realistic reloc inlier rates
                                       # (~45%) an all-inlier 6-point sample
                                       # has p~0.8%, so hundreds of batched
                                       # hypotheses are needed — they are one
                                       # vmapped eigh.
    staged_reloc: bool = True          # relocalize via wide-radius guided
                                       # matching around the stale pose
                                       # first, global matching as fallback
                                       # (self-similar texture makes global
                                       # matches mostly aliases)
    dup_radius_px: float = 48.0        # near-twin suppression radius for
                                       # new-landmark insertion; 0 = r4's
                                       # global descriptor-only gate (which
                                       # starves creation in self-similar
                                       # scenes as the map grows)
    tri_local_band: float = 1.8        # structure-aware alias gate: accept
                                       # a new landmark only if its depth is
                                       # within this factor of the median
                                       # depth of map landmarks projecting
                                       # within 40 px of the feature (0 =
                                       # off).  Targets period-aliased
                                       # matches (which land at ~0.5x/2x the
                                       # LOCAL depth) without the global
                                       # band's blindness to real depth
                                       # structure.  A/B (r5, fr1-like):
                                       # 292/300 tracked, 0 reboots, drift
                                       # 0.273/m vs 256-269 tracked with a
                                       # reboot for global-band-only configs
    reloc_max_frames: int = 8          # consecutive failed-relocalization
                                       # frames before DeviceVO abandons the
                                       # stale pose and re-seeds a FRESH
                                       # submap at the last known pose
                                       # (ORB-SLAM3 Atlas-style; 0 disables).
                                       # Without it a single unrecoverable
                                       # loss costs every remaining frame
                                       # (measured: 98 straight reloc
                                       # failures on the r5 eval)
    track_two_pass: bool = True        # re-match + re-optimize with refined pose
    second_pass_below: int = 150       # run the second pass only when the
                                       # first yields fewer inliers: its job
                                       # is rescuing weak frames; a frame
                                       # already above the keyframe-health
                                       # threshold gains nothing measurable
                                       # and the skip saves ~0.9 ms/frame
    min_parallax_deg: float = 1.5      # bootstrap/triangulation parallax gate
    tri_band_lo: float = 0.25          # triangulated-depth band vs the
    tri_band_hi: float = 4.0           # median in-view scene depth: period-
                                       # aliased epipolar matches (repetitive
                                       # texture) triangulate at integer
                                       # multiples/fractions of the true
                                       # depth and are reprojection-perfect
                                       # in both views, so only a scene-
                                       # relative depth band catches them.
                                       # r4 shipped [0.12, 8.0]: wide enough
                                       # that half/quarter-depth aliases
                                       # passed, each pulling the map scale
                                       # down (measured 0.24 log-scale/m
                                       # drift, 4.2x collapse over 7 m)


@dataclass(frozen=True)
class PoseGraphConfig(_JsonMixin):
    """Pose-graph optimization (loop closure back-end)."""

    max_nodes: int = 256
    max_edges: int = 1024
    gn_iters: int = 20
    loop_candidates: int = 2       # place-recognition candidates probed per
                                   # keyframe (one fused probe dispatch; the
                                   # probe shape is static in this count)
    loop_cooldown: int = 5         # keyframes to skip probing after an
                                   # accepted closure: back-to-back accepts
                                   # at a revisit re-measure the same
                                   # constraint and re-solve the graph per
                                   # keyframe for no information gain
    loop_min_matches: int = 40     # descriptor matches for a loop candidate
    loop_min_gap: int = 30         # keyframe index gap before closing loops
    loop_min_inlier_ratio: float = 0.4   # PnP inliers / map matches: a true
                                   # revisit re-finds most of the old view;
                                   # a lookalike wall (textured rooms are
                                   # self-similar) matches descriptors but
                                   # PnPs a scattered inlier set.  False
                                   # loop edges at weight 5 wreck the graph
                                   # — gate hard.
    loop_max_rmse_px: float = 4.0  # inlier reprojection RMSE gate
    loop_min_scale_pairs: int = 12 # features needing BOTH old- and new-gauge
                                   # landmark associations before the
                                   # measured relative scale s_e is trusted
                                   # (otherwise the Sim(3) edge ships s = 1)
    sim3: bool = True              # close loops over Sim(3) (monocular scale
                                   # drift); False = SE(3) edges only


@dataclass(frozen=True)
class MeshConfig(_JsonMixin):
    """Device-mesh layout for multi-chip / multi-host runs.

    Axes: ``frame`` = data parallelism over frames/hypotheses (front-end),
    ``landmark`` = landmark-block sharding for distributed BA (psum over the mesh).
    """

    frame_axis: int = 1
    landmark_axis: int = 1


@dataclass(frozen=True)
class SlamConfig(_JsonMixin):
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    vo: VOConfig = field(default_factory=VOConfig)
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
