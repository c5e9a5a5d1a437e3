"""Visual odometry: frame-to-frame tracking with keyframes, map maintenance
and sliding-window local BA (BASELINE configs 3-4).

Architecture (SURVEY §7 hard part 1): every per-frame compute stage —
extraction, map matching, PnP, triangulation, map insertion, window BA — is
a fixed-shape jitted function; the HOST makes the data-dependent decisions
(bootstrap readiness, keyframe insertion, track-loss) between stages from
scalar summaries.  The map is a fixed-capacity slotmap pytree (capacity +
valid mask), so no XLA shape ever depends on how many landmarks exist.

World frame = camera frame of the first keyframe.  Poses are world->camera.
Monocular scale is fixed at bootstrap by normalizing median scene depth.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from tinyslam.config import SlamConfig
from tinyslam.frontend.orb import OrbFrontend
from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.epipolar import depths, triangulate
from tinyslam.geometry.pnp import pnp_refine
from tinyslam.geometry.se3 import (
    se3_compose,
    se3_identity,
    se3_inverse,
)
from tinyslam.models.two_view import TwoViewEstimator
from tinyslam.ops.hamming import match_descriptors
from tinyslam.types import Features, pytree_dataclass


@pytree_dataclass
class MapState:
    """Fixed-capacity landmark slotmap."""

    X: jax.Array          # (M, 3) world positions
    desc: jax.Array       # (M, 8) uint32 BRIEF
    valid: jax.Array      # (M,)
    anchor_kf: jax.Array  # (M,) int32 — keyframe id that created the landmark
    obs_count: jax.Array  # (M,) int32 — gated keyframe observations
    last_seen: jax.Array  # (M,) int32 — keyframe id of last gated observation

    @staticmethod
    def empty(capacity: int) -> "MapState":
        return MapState(
            X=jnp.zeros((capacity, 3), jnp.float32),
            desc=jnp.zeros((capacity, 8), jnp.uint32),
            valid=jnp.zeros((capacity,), bool),
            anchor_kf=jnp.full((capacity,), -1, jnp.int32),
            obs_count=jnp.zeros((capacity,), jnp.int32),
            last_seen=jnp.full((capacity,), -1, jnp.int32),
        )


@functools.partial(jax.jit, static_argnames=(
    "max_distance", "ratio", "radius_px"))
def _match_to_map(feats: Features, map_state: MapState, max_distance: int,
                  ratio: float, cam: PinholeCamera | None = None,
                  R: jax.Array | None = None, t: jax.Array | None = None,
                  radius_px: float = 20.0):
    """Match features to the map.  With a predicted pose (cam, R, t), do
    GUIDED matching: a map point is only eligible within `radius_px` of its
    predicted projection — removing globally-ambiguous matches under
    repetitive texture and keeping PnP in its convergence basin."""
    xy_a = proj = None
    if R is not None:
        pc = map_state.X @ R.T + t                     # (M, 3)
        z = jnp.maximum(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        in_front = pc[..., 2] > 1e-4
        # Behind-camera landmarks: park the projection far outside any
        # radius so the gate rejects every pairing (branch-free in_front).
        far = jnp.float32(1e7)
        proj = jnp.stack([jnp.where(in_front, u, far),
                          jnp.where(in_front, v, far)], axis=-1)  # (M, 2)
        xy_a = feats.xy
    m = match_descriptors(
        feats.desc, feats.valid, map_state.desc, map_state.valid,
        max_distance=max_distance, ratio=ratio, cross_check=True,
        xy_a=xy_a, proj_b=proj, radius_px=radius_px,
    )
    return m["idx_b"], m["valid"]


@functools.partial(jax.jit, static_argnames=("iters",))
def _track_pnp(cam: PinholeCamera, feats: Features, map_state: MapState,
               map_idx: jax.Array, match_valid: jax.Array,
               R0: jax.Array, t0: jax.Array, iters: int, inlier_px: float):
    X = map_state.X[map_idx]
    return pnp_refine(cam, X, feats.xy, match_valid, R0, t0,
                      iters=iters, inlier_px=inlier_px)


@functools.partial(jax.jit, static_argnames=("max_new",))
def _triangulate_and_insert(
    cam: PinholeCamera,
    map_state: MapState,
    kf_id: jax.Array,
    R_a: jax.Array, t_a: jax.Array, feats_a: Features,
    R_b: jax.Array, t_b: jax.Array, feats_b: Features,
    idx_b: jax.Array, pair_valid: jax.Array,
    already_mapped_a: jax.Array,
    max_new: int,
    min_parallax_cos: float = 0.9998,
    max_reproj_px: float = 4.0,
    band_lo: float = 0.25,
    band_hi: float = 4.0,
    dup_radius_px: float = 48.0,
    local_band: float = 0.0,
):
    """Triangulate descriptor-matched (a, b) feature pairs and insert the
    accepted new landmarks into free map slots.

    idx_b: (N,) match of each a-feature in b; pair_valid: (N,).
    already_mapped_a: (N,) a-features that already track a landmark (skip).
    Returns (new_map_state, num_inserted).
    """
    xa = cam.normalize(feats_a.xy)                    # (N, 2)
    xb = cam.normalize(feats_b.xy[idx_b])
    cand = pair_valid & ~already_mapped_a

    X = triangulate(R_a, t_a, xa, R_b, t_b, xb)       # (N, 3)
    za = depths(R_a, t_a, X)
    zb = depths(R_b, t_b, X)

    # Reprojection checks in both views.
    def reproj_err(R, t, uv):
        pc = X @ R.T + t
        zz = jnp.maximum(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / zz + cam.cx
        v = cam.fy * pc[..., 1] / zz + cam.cy
        return jnp.linalg.norm(jnp.stack([u, v], -1) - uv, axis=-1)

    ea = reproj_err(R_a, t_a, feats_a.xy)
    eb = reproj_err(R_b, t_b, feats_b.xy[idx_b])

    # Parallax: angle between the two viewing rays.
    Ca = -jnp.einsum("ij,i->j", R_a, t_a)             # camera centers (world)
    Cb = -jnp.einsum("ij,i->j", R_b, t_b)
    ra = X - Ca
    rb = X - Cb
    cos_par = jnp.sum(ra * rb, -1) / jnp.maximum(
        jnp.linalg.norm(ra, axis=-1) * jnp.linalg.norm(rb, axis=-1), 1e-9
    )

    accept = (
        cand
        & (za > 0.05) & (zb > 0.05) & (za < 1e3) & (zb < 1e3)
        & (ea < max_reproj_px) & (eb < max_reproj_px)
        & (cos_par < min_parallax_cos)
        & jnp.all(jnp.isfinite(X), axis=-1)
    )

    # Relative depth-band gate against the VISIBLE scene.  Repetitive
    # texture (tiled walls, building facades) produces period-aliased
    # matches whose disparity is a multiple of the true one; such pairs are
    # EPIPOLAR-CONSISTENT, so they reproject perfectly in both views at a
    # wildly wrong depth (measured: a batch of 41 landmarks entering 7.7x
    # too close passed every geometric gate and collapsed the map scale).
    # A point several times closer/farther than the scene in THIS view is
    # overwhelmingly an alias; gate it.  The reference depth is the median
    # of map landmarks projecting INTO the current view — a whole-map
    # median stalls insertion when the camera approaches a surface (the
    # local scene is legitimately much closer than the map at large;
    # measured: landmark creation froze for ~20 keyframes near a wall and
    # the resulting coverage hole cost 110 frames of tracking).  Inactive
    # while too few landmarks are in view to define a scene depth.
    z_map = depths(R_a, t_a, map_state.X)
    pc_m = map_state.X @ R_a.T + t_a
    zs_m = jnp.maximum(pc_m[..., 2], 1e-6)
    u_m = cam.fx * pc_m[..., 0] / zs_m + cam.cx
    v_m = cam.fy * pc_m[..., 1] / zs_m + cam.cy
    in_view = (map_state.valid & (z_map > 0.02)
               & (u_m > 0) & (u_m < 2.0 * cam.cx + 1.0)
               & (v_m > 0) & (v_m < 2.0 * cam.cy + 1.0))
    med_z = jnp.nanmedian(jnp.where(in_view, z_map, jnp.nan))
    have_scene = jnp.sum(in_view) >= 30
    band_ok = (za > band_lo * med_z) & (za < band_hi * med_z)
    accept &= jnp.where(have_scene & jnp.isfinite(med_z), band_ok, True)

    # Duplicate suppression: a candidate whose descriptor is already in the
    # map would create a near-twin landmark; twins make the matcher's ratio
    # test reject BOTH (best ~ second-best), which progressively poisons
    # tracking.  One extra Hamming matmul kills them at the source.
    #
    # LOCALIZED (r5): the twin test is harmful only when the twin lands in
    # the same guided-matching neighbourhood — suppressing on descriptor
    # similarity ALONE starves landmark creation in self-similar scenes
    # (measured on the r5 eval: per-keyframe insertions collapsed from
    # ~100-300 to ~1-5 once the map passed ~3k landmarks, the map coverage
    # hole then killed tracking at frame ~215).  A twin is a (similar
    # descriptor) AND (projects within ~2x the guided radius) pair.
    from tinyslam.ops.hamming import hamming_distance_matrix

    d_map = hamming_distance_matrix(feats_a.desc, map_state.desc)   # (N, M)
    proj_m = jnp.stack([u_m, v_m], axis=-1)                         # (M, 2)
    pdist2 = jnp.sum(
        (feats_a.xy[:, None, :] - proj_m[None, :, :]) ** 2, axis=-1)
    near = (pdist2 < dup_radius_px ** 2) & in_view[None, :]
    similar = (d_map <= 40) & map_state.valid[None, :]
    # dup_radius_px = 0 falls back to the global descriptor-only gate.
    twin = jnp.where(dup_radius_px > 0, similar & near, similar)
    accept &= ~jnp.any(twin, axis=1)

    # Structure-aware alias gate (cfg.vo.tri_local_band): compare the
    # candidate's depth against the median depth of map landmarks
    # projecting within 40 px of it — a period-aliased match triangulates
    # at ~0.5x/2x the LOCAL scene depth and fails this even where the
    # global band (blind to depth structure) passes it.
    neigh = (pdist2 < 40.0 ** 2) & in_view[None, :]
    z_local = jnp.nanmedian(
        jnp.where(neigh, z_map[None, :], jnp.nan), axis=1)       # (N,)
    n_neigh = jnp.sum(neigh, axis=1)
    lb = jnp.maximum(local_band, 1.0)
    local_ok = (za > z_local / lb) & (za < z_local * lb)
    use_local = (local_band > 1.0) & (n_neigh >= 5) & jnp.isfinite(z_local)
    accept &= jnp.where(use_local, local_ok, True)

    # Rank candidates: accepted first (by feature score), take max_new.
    rank_key = jnp.where(accept, feats_a.score, -1.0)
    order = jnp.argsort(-rank_key)[:max_new]          # (max_new,)
    ins_ok = accept[order]                            # (max_new,)
    ins_X = X[order]
    ins_desc = feats_a.desc[order]

    free = jnp.argsort(map_state.valid)[:max_new]     # invalid slots first
    # Only claim a free slot if it is actually free AND we have a candidate.
    slot_free = ~map_state.valid[free]
    write = ins_ok & slot_free

    new_valid = map_state.valid.at[free].set(
        jnp.where(write, True, map_state.valid[free])
    )
    new_X = map_state.X.at[free].set(
        jnp.where(write[:, None], ins_X, map_state.X[free])
    )
    new_desc = map_state.desc.at[free].set(
        jnp.where(write[:, None], ins_desc, map_state.desc[free])
    )
    new_anchor = map_state.anchor_kf.at[free].set(
        jnp.where(write, kf_id, map_state.anchor_kf[free])
    )
    new_obs = map_state.obs_count.at[free].set(
        jnp.where(write, 1, map_state.obs_count[free])
    )
    new_seen = map_state.last_seen.at[free].set(
        jnp.where(write, kf_id, map_state.last_seen[free])
    )
    return (
        MapState(X=new_X, desc=new_desc, valid=new_valid, anchor_kf=new_anchor,
                 obs_count=new_obs, last_seen=new_seen),
        jnp.sum(write.astype(jnp.int32)),
    )


@jax.jit
def _record_obs(win_obs: jax.Array, win_mask: jax.Array, slot: jax.Array,
                map_idx: jax.Array, uv: jax.Array, valid: jax.Array,
                cam: PinholeCamera = None, map_X: jax.Array = None,
                R: jax.Array = None, t: jax.Array = None,
                gate_px: float = 8.0):
    """Record per-keyframe observations: win_obs (K, M, 2), win_mask (K, M).

    Observations are gated by reprojection error under the current geometry
    — descriptor matching has a wrong-match tail, and un-gated wrong
    observations accumulate in the BA window and drag it off."""
    if map_X is not None:
        pc = map_X[map_idx] @ R.T + t
        z = jnp.maximum(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        err = jnp.linalg.norm(jnp.stack([u, v], -1) - uv, axis=-1)
        valid = valid & (pc[..., 2] > 1e-4) & (err < gate_px)
    obs_k = win_obs[slot]
    mask_k = win_mask[slot]
    obs_k = obs_k.at[map_idx].set(jnp.where(valid[:, None], uv, obs_k[map_idx]))
    mask_k = mask_k.at[map_idx].set(jnp.where(valid, True, mask_k[map_idx]))
    return win_obs.at[slot].set(obs_k), win_mask.at[slot].set(mask_k), valid


@dataclass
class VOStats:
    frame: int = 0
    num_features: int = 0
    num_matches: int = 0
    num_inliers: int = 0
    num_landmarks: int = 0
    is_keyframe: bool = False
    tracking: bool = False
    rmse_px: float = 0.0


class VisualOdometry:
    """Monocular visual odometry with sliding-window BA."""

    def __init__(self, cfg: SlamConfig, camera: PinholeCamera,
                 bootstrap_depth: float = 2.0):
        self.cfg = cfg
        self.camera = camera
        self.frontend = OrbFrontend(cfg.frontend)
        self.two_view = TwoViewEstimator(camera, cfg.matcher, cfg.ransac)
        self.bootstrap_depth = bootstrap_depth
        self.reset()

    # ---------------- state ----------------
    def reset(self):
        cfg = self.cfg
        M = cfg.vo.max_map_points
        K = cfg.ba.max_keyframes
        self.map = MapState.empty(M)
        self.win_R = jnp.tile(jnp.eye(3)[None], (K, 1, 1)).astype(jnp.float32)
        self.win_t = jnp.zeros((K, 3), jnp.float32)
        self.win_obs = jnp.zeros((K, M, 2), jnp.float32)
        self.win_mask = jnp.zeros((K, M), bool)
        self.win_valid = np.zeros(K, bool)
        self.win_kf_id = np.full(K, -1, np.int64)
        self.win_feats: list[Features | None] = [None] * K  # per-slot features
        self.kf_feats: Features | None = None   # latest keyframe features
        self.kf_pose = se3_identity()
        self.kf0_feats: Features | None = None  # bootstrap reference
        self._kf0_frame = 0                     # frame kf0_feats came from
        self.num_keyframes = 0
        self.frame_idx = -1
        self.frames_since_kf = 0
        self.initialized = False
        self.R = jnp.eye(3, dtype=jnp.float32)
        self.t = jnp.zeros(3, jnp.float32)
        self.vel = se3_identity()               # constant-velocity model
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self.stats: list[VOStats] = []
        self.kf_poses_log: list[tuple[int, np.ndarray, np.ndarray]] = []
        # Frame index (this tracker's local numbering) at which each
        # keyframe was created — the dense-trajectory correction in
        # models/slam.py needs an exact kf -> frame map (inferring it from
        # is_keyframe stat flags mis-attributes corrections across
        # bootstrap re-seeds and submap reboots).
        self.kf_frames_log: list[int] = []
        # Force global relocalization on the next frame regardless of stats
        # history — set by checkpoint restore (the restored pose is stale by
        # however many frames elapsed after the snapshot, and stats are not
        # persisted, so the history-based trigger below cannot fire).
        self.force_reloc = False

    # ---------------- keyframe window ----------------
    def _push_keyframe(self, R, t, feats: Features, kf_id: int):
        K = self.cfg.ba.max_keyframes
        if self.win_valid.all():
            # roll: drop oldest
            self.win_R = jnp.roll(self.win_R, -1, axis=0)
            self.win_t = jnp.roll(self.win_t, -1, axis=0)
            self.win_obs = jnp.roll(self.win_obs, -1, axis=0)
            self.win_mask = jnp.roll(self.win_mask, -1, axis=0)
            self.win_valid = np.roll(self.win_valid, -1)
            self.win_kf_id = np.roll(self.win_kf_id, -1)
            self.win_feats = self.win_feats[1:] + [None]
            slot = K - 1
        else:
            slot = int(np.argmin(self.win_valid))  # first free slot
        self.win_R = self.win_R.at[slot].set(R)
        self.win_t = self.win_t.at[slot].set(t)
        self.win_obs = self.win_obs.at[slot].set(0.0)
        self.win_mask = self.win_mask.at[slot].set(False)
        self.win_valid[slot] = True
        self.win_kf_id[slot] = kf_id
        self.win_feats[slot] = feats
        return slot

    def _record_kf_observations(self, slot: int, feats: Features):
        """Match the keyframe's features to the map and store observations
        (reprojection-gated against the slot's current pose)."""
        # Wider radius than tracking (see vo_device._record_kf_obs): keyframe
        # re-observation re-anchors old landmarks into the BA window.
        idx, mvalid = _match_to_map(
            feats, self.map, self.cfg.matcher.max_distance, self.cfg.matcher.ratio,
            cam=self.camera, R=self.win_R[slot], t=self.win_t[slot],
            radius_px=32.0,
        )
        self.win_obs, self.win_mask, gated = _record_obs(
            self.win_obs, self.win_mask, jnp.int32(slot), idx, feats.xy, mvalid,
            cam=self.camera, map_X=self.map.X,
            R=self.win_R[slot], t=self.win_t[slot],
        )
        # Refresh landmark descriptors from the latest observation — a
        # descriptor frozen at birth goes stale as the viewpoint drifts and
        # map matching decays with it (ORB-SLAM refreshes likewise).
        # CRITICAL: refresh only reprojection-GATED matches.  Refreshing on a
        # confidently-wrong match overwrites the landmark's appearance with a
        # different corner's, permanently divorcing descriptor from 3D
        # position — matches stay high while PnP inliers collapse.
        new_desc = self.map.desc.at[idx].set(
            jnp.where(gated[:, None], feats.desc, self.map.desc[idx])
        )
        kf_id = jnp.int32(self.win_kf_id[slot])
        new_obs = self.map.obs_count.at[idx].add(gated.astype(jnp.int32))
        new_seen = self.map.last_seen.at[idx].set(
            jnp.where(gated, kf_id, self.map.last_seen[idx])
        )
        self.map = self.map.replace(desc=new_desc, obs_count=new_obs,
                                    last_seen=new_seen)

    def _local_ba(self):
        cfg = self.cfg.ba
        K = cfg.max_keyframes
        n_valid = int(self.win_valid.sum())
        if n_valid < 3:
            return
        pose_free = jnp.asarray(
            self.win_valid
            & (np.arange(K) >= 2)  # oldest slots are the gauge (slot order = age)
        )
        z = jnp.swapaxes(self.win_obs, 0, 1)          # (M, K, 2)
        mask = jnp.swapaxes(self.win_mask, 0, 1) & jnp.asarray(self.win_valid)[None, :]
        # Only optimize landmarks with >= 2 window observations: a single
        # observation leaves the depth unconstrained (2 equations, 3
        # unknowns) and LM would drag the point along its ray arbitrarily.
        multi_obs = jnp.sum(mask.astype(jnp.int32), axis=1) >= 2
        from tinyslam.backend.ba import bundle_adjust

        out = bundle_adjust(
            self.camera, self.win_R, self.win_t, self.map.X, z, mask,
            pose_free, point_valid=self.map.valid & multi_obs,
            max_iters=cfg.max_iters, huber=cfg.huber_delta,
            lam0=cfg.damping_init, lam_up=cfg.damping_up,
            lam_down=cfg.damping_down,
        )
        self.win_R, self.win_t = out["R"], out["t"]
        self.map = self.map.replace(X=out["X"])
        # Current pose = newest keyframe pose after BA.
        newest = int(np.nonzero(self.win_valid)[0].max())
        self.R, self.t = self.win_R[newest], self.win_t[newest]
        self.kf_pose = (self.R, self.t)

    # ---------------- bootstrap ----------------
    def _try_bootstrap(self, feats: Features) -> bool:
        res = self.two_view.estimate(self.kf0_feats, feats,
                                     key=jax.random.PRNGKey(self.frame_idx))
        # ONE packed readback for the whole attempt: each separate int()/
        # np.asarray() below would be its own device->host sync.
        res = {k: v for k, v in jax.device_get(res).items() if k != "model"}
        n_matches = int(np.sum(res["match_valid"]))
        if n_matches < 50:
            # Scene overlap with the reference keyframe is gone — re-seed.
            self.kf0_feats = feats
            self._kf0_frame = self.frame_idx
            return False
        n_in = int(res["num_inliers"])
        if n_in < 60:
            return False
        X = np.asarray(res["points"])                  # frame-KF0 coords
        good = np.asarray(res["inliers"] & res["match_valid"]).copy()
        good &= np.isfinite(X).all(axis=-1) & (X[:, 2] > 0.1) & (X[:, 2] < 1e4)
        if good.sum() < 50:
            return False
        med_depth = float(np.median(X[good][:, 2]))
        # Parallax gate: a near-zero baseline triangulates garbage depths
        # (classic mono-SLAM failure).  Require median ray-angle parallax.
        R_np = np.asarray(res["R"])
        t_np = np.asarray(res["t"])
        C1 = -R_np.T @ t_np                        # second camera center
        Xg = X[good]
        r0 = Xg
        r1 = Xg - C1
        cosp = np.sum(r0 * r1, -1) / np.maximum(
            np.linalg.norm(r0, axis=-1) * np.linalg.norm(r1, axis=-1), 1e-12
        )
        med_par = np.degrees(np.arccos(np.clip(np.median(cosp), -1, 1)))
        if not (med_par >= self.cfg.vo.min_parallax_deg):  # NaN-safe reject
            return False
        scale = self.bootstrap_depth / med_depth
        R_rel = res["R"]
        t_rel = res["t"] * scale
        Xs = X * scale

        # World frame := KF0 camera frame.  Insert map points.
        M = self.cfg.vo.max_map_points
        n = min(int(good.sum()), M)
        sel = np.nonzero(good)[0][:n]
        self.map = MapState(
            X=self.map.X.at[:n].set(jnp.asarray(Xs[sel], jnp.float32)),
            desc=self.map.desc.at[:n].set(self.kf0_feats.desc[jnp.asarray(sel)]),
            valid=self.map.valid.at[:n].set(True),
            anchor_kf=self.map.anchor_kf.at[:n].set(0),
            obs_count=self.map.obs_count.at[:n].set(1),
            last_seen=self.map.last_seen.at[:n].set(0),
        )
        # Keyframes: KF0 at identity, current at (R_rel, t_rel).
        R0, t0 = se3_identity()
        s0 = self._push_keyframe(R0, t0, self.kf0_feats, kf_id=0)
        self._record_kf_observations(s0, self.kf0_feats)
        s1 = self._push_keyframe(R_rel, t_rel, feats, kf_id=1)
        self._record_kf_observations(s1, feats)
        self.kf_poses_log.append((0, np.asarray(R0), np.asarray(t0)))
        self.kf_poses_log.append((1, np.asarray(R_rel), np.asarray(t_rel)))
        self.kf_frames_log.append(self._kf0_frame)
        self.kf_frames_log.append(self.frame_idx)
        self.num_keyframes = 2
        self.R, self.t = R_rel, t_rel
        self.kf_feats = feats
        self.kf_pose = (R_rel, t_rel)
        self.vel = se3_identity()
        self._local_ba()
        self.initialized = True
        self.frames_since_kf = 0
        return True

    # ---------------- keyframe insertion ----------------
    def _best_baseline_slot(self) -> int | None:
        """Window slot with the largest camera-center distance to the
        current pose: back-to-back keyframes have ~zero baseline (their
        triangulations all fail the parallax gate), so new map points must
        come from the widest pair the window still holds."""
        valid = np.nonzero(self.win_valid)[0]
        if len(valid) == 0:
            return None
        C_cur = np.asarray(-self.R.T @ self.t)
        best, best_d = None, -1.0
        for s in valid:
            if self.win_feats[s] is None:
                continue
            R_s = np.asarray(self.win_R[s])
            t_s = np.asarray(self.win_t[s])
            d = float(np.linalg.norm(-R_s.T @ t_s - C_cur))
            if d > best_d:
                best, best_d = int(s), d
        return best

    def _insert_keyframe(self, feats: Features, map_idx, match_valid, inliers):
        kf_id = self.num_keyframes
        self.num_keyframes += 1
        already = match_valid & inliers               # features with landmarks
        # Dual-reference triangulation: the previous keyframe (matches best,
        # small baseline) AND the widest-baseline window keyframe
        # (triangulates best, matches worst); the parallax/reprojection
        # gates keep whichever pairs are well-conditioned.
        newest = (int(np.nonzero(self.win_valid)[0].max())
                  if self.win_valid.any() else None)
        refs = []
        for r in (newest, self._best_baseline_slot()):
            if r is not None and r not in refs and self.win_feats[r] is not None:
                refs.append(r)
        n_new = 0
        for ref in refs:
            ref_feats = self.win_feats[ref]
            R_b, t_b = self.win_R[ref], self.win_t[ref]
            m = match_descriptors(
                feats.desc, feats.valid, ref_feats.desc, ref_feats.valid,
                max_distance=self.cfg.matcher.max_distance,
                ratio=self.cfg.matcher.ratio, cross_check=True,
            )
            self.map, n_ins = _triangulate_and_insert(
                self.camera, self.map, jnp.int32(kf_id),
                self.R, self.t, feats,
                R_b, t_b, ref_feats,
                m["idx_b"], m["valid"], already,
                max_new=self.cfg.frontend.features_per_level,
                band_lo=self.cfg.vo.tri_band_lo,
                band_hi=self.cfg.vo.tri_band_hi,
                dup_radius_px=self.cfg.vo.dup_radius_px,
                local_band=self.cfg.vo.tri_local_band,
            )
            n_new += int(n_ins)
            # Re-record the partner's observations so the landmarks just
            # created get their second view registered.
            self._record_kf_observations(ref, ref_feats)
        slot = self._push_keyframe(self.R, self.t, feats, kf_id)
        self._record_kf_observations(slot, feats)
        self.kf_feats = feats
        self.kf_pose = (self.R, self.t)
        self.kf_poses_log.append((kf_id, np.asarray(self.R), np.asarray(self.t)))
        self.kf_frames_log.append(self.frame_idx)
        self._cull_landmarks(kf_id)
        self._local_ba()
        self.frames_since_kf = 0
        return int(n_new)

    def _cull_landmarks(self, kf_id: int, max_age: int = 10, min_obs: int = 2):
        """Invalidate landmarks that stayed single-observation for several
        keyframes — they only consume capacity and matcher ambiguity
        (reference roadmap item 'Cull unnecessary map points')."""
        age = jnp.int32(kf_id) - self.map.last_seen
        weak = (self.map.obs_count < min_obs) & (age > max_age)
        self.map = self.map.replace(valid=self.map.valid & ~weak)

    # ---------------- per-frame ----------------
    def process(self, image) -> VOStats:
        self.frame_idx += 1
        cfg = self.cfg
        feats = self.frontend.extract(image)
        st = VOStats(frame=self.frame_idx, num_features=int(feats.count),
                     num_landmarks=int(jnp.sum(self.map.valid)))

        if not self.initialized:
            if self.kf0_feats is None:
                self.kf0_feats = feats
                self._kf0_frame = self.frame_idx
                st.is_keyframe = True
            else:
                # Attempt throttle: the first two frames after the seed have
                # near-zero baseline and always fail the parallax gate; an
                # attempt costs a two-view RANSAC + readback, so skip only
                # those (a sparser schedule measurably
                # perturbs which frame bootstrap succeeds on and the whole
                # downstream trajectory with it).
                age = self.frame_idx - self._kf0_frame
                if age >= 3 and self._try_bootstrap(feats):
                    st.tracking = True
                    st.is_keyframe = True
                    st.num_landmarks = int(jnp.sum(self.map.valid))
            self.trajectory.append((np.asarray(self.R), np.asarray(self.t)))
            self.stats.append(st)
            return st

        # ---- tracking ----
        Rv, tv = self.vel
        R_pred, t_pred = se3_compose(Rv, tv, self.R, self.t)
        relocalizing = self.force_reloc or (
            bool(self.stats) and not self.stats[-1].tracking)
        self.force_reloc = False
        if relocalizing:
            # Lost last frame: the prediction is unreliable — absolute-pose
            # RANSAC (pnp_refine alone is a local method and cannot recover
            # from a stale pose).  STAGED matching (r5): under self-similar
            # texture a fully global match is mostly aliases (measured on
            # the r5 eval: ~150 ratio-passing matches, <= 3 PnP inliers,
            # 98 consecutive reloc failures), while the stale pose is
            # usually only a few frames old — so first try a WIDE-radius
            # guided match around it, and only fall back to the global
            # match if that cannot seat a pose.
            from tinyslam.geometry.pnp import pnp_ransac

            def _reloc_attempt(guided: bool):
                if guided:
                    i_, v_ = _match_to_map(
                        feats, self.map, cfg.matcher.max_distance,
                        cfg.matcher.ratio,
                        cam=self.camera, R=R_pred, t=t_pred, radius_px=64.0)
                else:
                    i_, v_ = _match_to_map(
                        feats, self.map, cfg.matcher.max_distance,
                        cfg.matcher.ratio)
                o_ = pnp_ransac(
                    self.camera, self.map.X[i_], feats.xy, v_,
                    jax.random.PRNGKey(self.frame_idx),
                    num_hypotheses=cfg.vo.reloc_hypotheses,
                    inlier_px=cfg.vo.pnp_inlier_px,
                    refine_iters=cfg.vo.pnp_iters,
                    # The stale pose as one extra hypothesis: after a
                    # restore or a brief occlusion it is often still the
                    # best initializer, and it costs one vote pass.
                    R_prior=R_pred, t_prior=t_pred,
                )
                return i_, v_, o_

            if cfg.vo.staged_reloc:
                idx, mvalid, out = _reloc_attempt(True)
                if int(out["num_inliers"]) < 20:
                    idx_g, mvalid_g, out_g = _reloc_attempt(False)
                    if int(out_g["num_inliers"]) > int(out["num_inliers"]):
                        idx, mvalid, out = idx_g, mvalid_g, out_g
            else:
                idx, mvalid, out = _reloc_attempt(False)
        else:
            idx, mvalid = _match_to_map(
                feats, self.map, cfg.matcher.max_distance, cfg.matcher.ratio,
                cam=self.camera, R=R_pred, t=t_pred,
                radius_px=cfg.vo.track_radius_px,
            )
            out = _track_pnp(
                self.camera, feats, self.map, idx, mvalid, R_pred, t_pred,
                iters=cfg.vo.pnp_iters, inlier_px=cfg.vo.pnp_inlier_px,
            )
        st.num_matches = int(jnp.sum(mvalid))
        if cfg.vo.track_two_pass and (
                15 <= int(out["num_inliers"]) < cfg.vo.second_pass_below):
            # Second pass (ORB-SLAM's track-local-map): with the refined
            # pose, re-match under a tighter projection radius — recovers
            # matches the coarse prediction radius missed or mis-assigned —
            # and re-optimize.
            idx2, mvalid2 = _match_to_map(
                feats, self.map, cfg.matcher.max_distance, cfg.matcher.ratio,
                cam=self.camera, R=out["R"], t=out["t"], radius_px=8.0,
            )
            if int(jnp.sum(mvalid2)) >= int(jnp.sum(mvalid)):
                out2 = _track_pnp(
                    self.camera, feats, self.map, idx2, mvalid2,
                    out["R"], out["t"],
                    iters=cfg.vo.pnp_iters, inlier_px=cfg.vo.pnp_inlier_px,
                )
                if int(out2["num_inliers"]) >= int(out["num_inliers"]):
                    out = out2
                    idx, mvalid = idx2, mvalid2
        n_in = int(out["num_inliers"])
        st.num_inliers = n_in
        st.rmse_px = float(out["rmse"])
        pose_finite = bool(
            np.isfinite(np.asarray(out["R"])).all()
            and np.isfinite(np.asarray(out["t"])).all()
        )
        if n_in >= 20 and pose_finite and st.rmse_px < 3.0 * cfg.vo.pnp_inlier_px:
            R_prev, t_prev = self.R, self.t
            self.R, self.t = out["R"], out["t"]
            if relocalizing:
                # The previous pose was stale (that's why we relocalized);
                # a velocity computed from it would be a huge bogus delta.
                self.vel = se3_identity()
            else:
                Ri, ti = se3_inverse(R_prev, t_prev)
                Rv, tv = se3_compose(self.R, self.t, Ri, ti)
                # Low-pass the constant-velocity model: per-frame translation
                # along the optical axis is weakly observable against distant
                # structure, and feeding raw frame-to-frame deltas back as the
                # next prediction amplifies that noise into oscillation.
                from tinyslam.geometry.se3 import (
                    se3_exp as _exp,
                    se3_log as _log,
                )

                xi_new = _log(Rv, tv)
                xi_old = _log(*self.vel)
                self.vel = _exp(0.6 * xi_new + 0.4 * xi_old)
            st.tracking = True
        else:
            # Tracking lost: hold the last pose and reset the motion model —
            # integrating a stale velocity every frame diverges exponentially.
            self.vel = se3_identity()
            st.tracking = False

        self.frames_since_kf += 1
        need_kf = st.tracking and (
            self.frames_since_kf >= cfg.vo.keyframe_max_interval
            or (n_in < cfg.vo.keyframe_min_inliers
                and self.frames_since_kf >= cfg.vo.keyframe_min_interval)
            or n_in < cfg.vo.keyframe_critical_inliers
        )
        if need_kf:
            self._insert_keyframe(feats, idx, mvalid, out["inliers"])
            st.is_keyframe = True
            st.num_landmarks = int(jnp.sum(self.map.valid))

        self.trajectory.append((np.asarray(self.R), np.asarray(self.t)))
        self.stats.append(st)
        return st

    def run(self, images) -> list[VOStats]:
        return [self.process(im) for im in images]

    @property
    def positions(self) -> np.ndarray:
        """Camera centers (world frame) of the trajectory."""
        out = []
        for R, t in self.trajectory:
            out.append(-R.T @ t)
        return np.asarray(out)
