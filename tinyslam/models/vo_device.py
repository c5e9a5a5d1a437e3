"""Device-resident visual odometry: the whole tracking loop as one scan.

The host-driven `VisualOdometry` (models/vo.py) makes its data-dependent
decisions between jitted stages — idiomatic, but every decision is a
device->host scalar readback, and each readback stalls the device queue,
so a ~12-readback frame loop is capped by round trips no matter how fast
the kernels are.  The reference has the same disease in miniature: one full
CPU<->GPU round-trip per frame (reference src/orb.rs:541-547 submit +
device.poll(Wait) + staging readback).

This module is the device-resident answer (SURVEY §3.2 note: "frames stay
device-resident; only compact pose/feature summaries ever reach the host,
asynchronously"):

- ALL per-frame control flow — relocalization fallback, two-pass
  track-local-map, pose acceptance, keyframe insertion, sliding-window BA,
  landmark culling — is compiled into the step via `lax.cond`/`jnp.where`;
- `lax.scan` runs a CHUNK of frames per dispatch;
- the host reads back one packed (chunk, S) summary array per chunk and
  uses it only for logging; nothing on the device ever waits for it.

Semantics match models/vo.py step-for-step (the tests assert both track
the same synthetic sequences); only the decision *mechanism* moves from
Python `if` on readbacks to `lax.cond` on device scalars.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from tinyslam.config import SlamConfig
from tinyslam.frontend.orb import extract_features
from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.se3 import (
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
)
from tinyslam.models.vo import (
    MapState,
    VisualOdometry,
    VOStats,
    _match_to_map,
    _record_obs,
    _track_pnp,
    _triangulate_and_insert,
)
from tinyslam.ops.hamming import match_descriptors
from tinyslam.types import Features, pytree_dataclass


# Device-side ring of per-keyframe features, independent of window rolling:
# a keyframe that rolls out of the BA window within one chunk (keyframe-dense
# sequences) must still be able to seed loop closures (VERDICT r3 weak #5).
# The ring needs to cover the keyframes created between host syncs — at most
# one per tracked frame, i.e. at most `chunk` (DeviceVO asserts chunk <= ring).
KF_RING = 32


@pytree_dataclass
class VOState:
    """Everything the tracker carries frame-to-frame, device-resident."""

    map: MapState
    win_R: jax.Array        # (K, 3, 3)
    win_t: jax.Array        # (K, 3)
    win_obs: jax.Array      # (K, M, 2)
    win_mask: jax.Array     # (K, M)
    win_valid: jax.Array    # (K,) bool
    win_kf_id: jax.Array    # (K,) int32, -1 = free
    win_feats: Features     # per-slot keyframe features, leading dim K
    kf_ring: Features       # per-KEYFRAME features, slot kf_id % KF_RING
    R: jax.Array            # (3, 3) current pose (world->camera)
    t: jax.Array            # (3,)
    vel_R: jax.Array        # (3, 3) constant-velocity model (frame-to-frame)
    vel_t: jax.Array        # (3,)
    num_keyframes: jax.Array    # () int32
    frames_since_kf: jax.Array  # () int32
    frame_idx: jax.Array        # () int32 — monotone counter (reloc RNG)
    last_tracking: jax.Array    # () bool
    threshold: jax.Array        # () float32 — adaptive FAST threshold

    @staticmethod
    def empty(cfg: SlamConfig) -> "VOState":
        """A zero state with the config's static shapes — the restore target
        for checkpointing (utils/checkpoint.save_device_vo) and the template
        for multi-chip dryruns."""
        K = cfg.ba.max_keyframes
        M = cfg.vo.max_map_points
        cap = cfg.frontend.max_features
        empty_feats = Features.empty(cap)
        return VOState(
            map=MapState.empty(M),
            win_R=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (K, 1, 1)),
            win_t=jnp.zeros((K, 3), jnp.float32),
            win_obs=jnp.zeros((K, M, 2), jnp.float32),
            win_mask=jnp.zeros((K, M), bool),
            win_valid=jnp.zeros((K,), bool),
            win_kf_id=jnp.full((K,), -1, jnp.int32),
            win_feats=jax.tree.map(
                lambda x: jnp.broadcast_to(x[None], (K, *x.shape)).copy(),
                empty_feats),
            kf_ring=jax.tree.map(
                lambda x: jnp.broadcast_to(
                    x[None], (KF_RING, *x.shape)).copy(),
                empty_feats),
            R=jnp.eye(3, dtype=jnp.float32),
            t=jnp.zeros((3,), jnp.float32),
            vel_R=jnp.eye(3, dtype=jnp.float32),
            vel_t=jnp.zeros((3,), jnp.float32),
            num_keyframes=jnp.int32(0),
            frames_since_kf=jnp.int32(0),
            frame_idx=jnp.int32(0),
            last_tracking=jnp.asarray(False),
            threshold=jnp.float32(cfg.frontend.threshold),
        )


# Packed per-frame summary layout (float32): keep in sync with VOStats use.
SUMMARY_FIELDS = (
    "num_features", "num_matches", "num_inliers", "tracking",
    "is_keyframe", "num_landmarks", "rmse_px", "threshold",
)


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(
        jnp.reshape(pred, (1,) * x.ndim), x, y), a, b)


def _newest_slot(win_kf_id: jax.Array) -> jax.Array:
    return jnp.argmax(win_kf_id)


def _record_kf_obs(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                   slot: jax.Array, feats: Features) -> VOState:
    """Device analog of VisualOdometry._record_kf_observations: match the
    keyframe's features to the map, gate by reprojection, store window
    observations, refresh descriptors / obs_count / last_seen."""
    # Wider radius than frame-to-frame tracking: keyframe re-observation is
    # what re-anchors OLD landmarks into the BA window (the longer an old
    # landmark stays observed, the slower the monocular scale random-walks);
    # the reprojection gate inside _record_obs keeps the alias risk bounded.
    idx, mvalid = _match_to_map(
        feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
        cam=cam, R=state.win_R[slot], t=state.win_t[slot], radius_px=32.0,
    )
    win_obs, win_mask, gated = _record_obs(
        state.win_obs, state.win_mask, slot.astype(jnp.int32), idx,
        feats.xy, mvalid,
        cam=cam, map_X=state.map.X, R=state.win_R[slot], t=state.win_t[slot],
    )
    m = state.map
    new_desc = m.desc.at[idx].set(
        jnp.where(gated[:, None], feats.desc, m.desc[idx]))
    kf_id = state.win_kf_id[slot]
    new_obs = m.obs_count.at[idx].add(gated.astype(jnp.int32))
    new_seen = m.last_seen.at[idx].set(jnp.where(gated, kf_id, m.last_seen[idx]))
    return state.replace(
        win_obs=win_obs, win_mask=win_mask,
        map=m.replace(desc=new_desc, obs_count=new_obs, last_seen=new_seen),
    )


def _push_keyframe(state: VOState, R, t, feats: Features,
                   kf_id) -> tuple[VOState, jax.Array]:
    """Device analog of VisualOdometry._push_keyframe: roll the window when
    full (slot order = age), else take the first free slot."""
    K = state.win_valid.shape[0]
    full = jnp.all(state.win_valid)

    def rolled(x):
        return jnp.roll(x, -1, axis=0)

    win_R = jnp.where(full, rolled(state.win_R), state.win_R)
    win_t = jnp.where(full, rolled(state.win_t), state.win_t)
    win_obs = jnp.where(full, rolled(state.win_obs), state.win_obs)
    win_mask = jnp.where(full, rolled(state.win_mask), state.win_mask)
    win_valid = jnp.where(full, rolled(state.win_valid), state.win_valid)
    win_kf_id = jnp.where(full, rolled(state.win_kf_id), state.win_kf_id)
    win_feats = jax.tree.map(
        lambda x: jnp.where(
            jnp.reshape(full, (1,) * x.ndim), rolled(x), x),
        state.win_feats)

    slot = jnp.where(full, K - 1, jnp.argmin(win_valid))
    win_R = win_R.at[slot].set(R)
    win_t = win_t.at[slot].set(t)
    win_obs = win_obs.at[slot].set(0.0)
    win_mask = win_mask.at[slot].set(False)
    win_valid = win_valid.at[slot].set(True)
    win_kf_id = win_kf_id.at[slot].set(kf_id)
    win_feats = jax.tree.map(
        lambda w, f: w.at[slot].set(f), win_feats, feats)
    return state.replace(
        win_R=win_R, win_t=win_t, win_obs=win_obs, win_mask=win_mask,
        win_valid=win_valid, win_kf_id=win_kf_id, win_feats=win_feats,
    ), slot


def _local_ba(cam: PinholeCamera, cfg: SlamConfig, state: VOState) -> VOState:
    """Device analog of VisualOdometry._local_ba (skip handled by caller's
    cond on >= 3 valid keyframes).

    The BA problem is COMPACTED to the cfg.ba.max_landmarks most-observed
    window landmarks before the LM scan: the map store is sized for the
    whole session (max_map_points slots) but only window-visible points
    constrain the window, so running the normal-equation kernels over every
    slot wastes a ~4x factor of bandwidth per LM iteration (measured: 1.6ms
    -> 0.4ms per blocks build at 8192 -> 2048).  Landmark selection is a
    static-shape top-k on observation count; updated positions scatter back.
    """
    from tinyslam.backend.ba import bundle_adjust

    K = cfg.ba.max_keyframes
    C = min(cfg.ba.max_landmarks, cfg.vo.max_map_points)
    pose_free = state.win_valid & (jnp.arange(K) >= 2)
    z = jnp.swapaxes(state.win_obs, 0, 1)            # (M, K, 2)
    mask = jnp.swapaxes(state.win_mask, 0, 1) & state.win_valid[None, :]
    obs_cnt = jnp.sum(mask.astype(jnp.int32), axis=1)
    score = jnp.where(state.map.valid & (obs_cnt >= 2), obs_cnt, -1)
    _, sel = jax.lax.top_k(score, C)                 # (C,)
    sel_ok = score[sel] > 0
    out = bundle_adjust(
        cam, state.win_R, state.win_t, state.map.X[sel], z[sel], mask[sel],
        pose_free, point_valid=sel_ok,
        max_iters=cfg.ba.max_iters, huber=cfg.ba.huber_delta,
        lam0=cfg.ba.damping_init, lam_up=cfg.ba.damping_up,
        lam_down=cfg.ba.damping_down,
    )
    X_new = state.map.X.at[sel].set(
        jnp.where(sel_ok[:, None], out["X"], state.map.X[sel]))
    newest = _newest_slot(state.win_kf_id)
    R_new, t_new = out["R"][newest], out["t"][newest]
    return state.replace(
        win_R=out["R"], win_t=out["t"], map=state.map.replace(X=X_new),
        R=R_new, t=t_new,
    )


def _cull_landmarks(state: VOState, kf_id, max_age: int = 10,
                    min_obs: int = 2) -> VOState:
    age = kf_id - state.map.last_seen
    weak = (state.map.obs_count < min_obs) & (age > max_age)
    return state.replace(map=state.map.replace(valid=state.map.valid & ~weak))


def _best_baseline_slot(state: VOState) -> jax.Array:
    """Window slot with the largest camera-center distance to the current
    pose (see VisualOdometry._best_baseline_slot): back-to-back keyframes
    triangulate nothing, so new map points come from the widest pair."""
    C_cur = -jnp.einsum("ij,i->j", state.R, state.t)
    C_win = -jnp.einsum("kij,ki->kj", state.win_R, state.win_t)  # (K, 3)
    d = jnp.linalg.norm(C_win - C_cur, axis=-1)
    return jnp.argmax(jnp.where(state.win_valid, d, -1.0))


def _insert_keyframe(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                     feats: Features, match_valid, inliers) -> VOState:
    """Device analog of VisualOdometry._insert_keyframe."""
    kf_id = state.num_keyframes
    already = match_valid & inliers
    # Dual-reference triangulation: the PREVIOUS keyframe matches best
    # (small viewpoint change) but may have little baseline; the WIDEST-
    # baseline window keyframe triangulates best but matches worst.  Run
    # both; the parallax/reprojection gates inside _triangulate_and_insert
    # keep whichever pairs are actually well-conditioned.
    refs = [_newest_slot(state.win_kf_id), _best_baseline_slot(state)]
    for ref in refs:
        ref_feats = jax.tree.map(lambda x: x[ref], state.win_feats)
        R_b, t_b = state.win_R[ref], state.win_t[ref]
        m = match_descriptors(
            feats.desc, feats.valid, ref_feats.desc, ref_feats.valid,
            max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio,
            cross_check=True,
        )
        new_map, _ = _triangulate_and_insert(
            cam, state.map, kf_id,
            state.R, state.t, feats,
            R_b, t_b, ref_feats,
            m["idx_b"], m["valid"], already,
            max_new=cfg.frontend.features_per_level,
            band_lo=cfg.vo.tri_band_lo,
            band_hi=cfg.vo.tri_band_hi,
            dup_radius_px=cfg.vo.dup_radius_px,
            local_band=cfg.vo.tri_local_band,
        )
        state = state.replace(map=new_map)
        # Second-view registration for the just-triangulated landmarks.
        state = _record_kf_obs(cam, cfg, state, ref, ref_feats)
    state, slot = _push_keyframe(state, state.R, state.t, feats, kf_id)
    state = _record_kf_obs(cam, cfg, state, slot, feats)
    ring_slot = jnp.mod(kf_id, KF_RING)
    state = state.replace(
        num_keyframes=kf_id + 1, frames_since_kf=jnp.int32(0),
        kf_ring=jax.tree.map(
            lambda w, f: w.at[ring_slot].set(f), state.kf_ring, feats),
    )
    state = _cull_landmarks(state, kf_id)
    n_valid = jnp.sum(state.win_valid.astype(jnp.int32))
    return jax.lax.cond(
        n_valid >= 3, lambda s: _local_ba(cam, cfg, s), lambda s: s, state)


def track_step(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
               image: jax.Array) -> tuple[VOState, dict]:
    """One tracked frame, entirely on device.  Mirrors the tracking section
    of VisualOdometry.process (models/vo.py) decision-for-decision.

    `image` may be float in [0, 1] or uint8 — camera frames should be
    shipped host->device as uint8 (4x less host-to-device traffic) and normalized
    here, on device."""
    if image.dtype == jnp.uint8:
        image = image.astype(jnp.float32) * (1.0 / 255.0)
    feats = extract_features(image, state.threshold, cfg.frontend)

    # Adaptive FAST threshold (same device-side controller as OrbFrontend).
    if cfg.frontend.adaptive_threshold:
        from tinyslam.frontend.orb import adapt_threshold

        state = state.replace(threshold=adapt_threshold(
            state.threshold, feats.count, feats.capacity,
            cfg.frontend.target_fill))

    R_pred, t_pred = se3_compose(state.vel_R, state.vel_t, state.R, state.t)

    # Tracking: guided matching against the predicted pose + local PnP.
    # Relocalization (last frame lost): GLOBAL matching + absolute-pose
    # RANSAC — a local GN from a stale pose cannot recover.
    def track_branch(_):
        idx, mvalid = _match_to_map(
            feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
            cam=cam, R=R_pred, t=t_pred,
            radius_px=cfg.vo.track_radius_px)
        out = _track_pnp(cam, feats, state.map, idx, mvalid, R_pred, t_pred,
                         iters=cfg.vo.pnp_iters,
                         inlier_px=cfg.vo.pnp_inlier_px)
        return idx, mvalid, out

    def reloc_branch(_):
        from tinyslam.geometry.pnp import pnp_ransac

        key = jax.random.fold_in(jax.random.PRNGKey(17), state.frame_idx)

        # Staged reloc (r5, mirrors models/vo.py): wide-radius guided match
        # around the stale pose first (self-similar texture makes the global
        # match mostly aliases), global match as the fallback; keep whichever
        # PnP seats more inliers.
        def attempt(guided):
            if guided:
                idx, mvalid = _match_to_map(
                    feats, state.map, cfg.matcher.max_distance,
                    cfg.matcher.ratio, cam=cam, R=R_pred, t=t_pred,
                    radius_px=64.0)
            else:
                idx, mvalid = _match_to_map(
                    feats, state.map, cfg.matcher.max_distance,
                    cfg.matcher.ratio)
            out = pnp_ransac(
                cam, state.map.X[idx], feats.xy, mvalid, key,
                num_hypotheses=cfg.vo.reloc_hypotheses,
                inlier_px=cfg.vo.pnp_inlier_px,
                refine_iters=cfg.vo.pnp_iters,
                # The stale pose as one extra hypothesis (same as the host
                # loop): after a restore or occlusion it is often closest.
                R_prior=R_pred, t_prior=t_pred)
            out = {k: out[k]
                   for k in ("R", "t", "inliers", "num_inliers", "rmse")}
            return idx, mvalid, out

        if not cfg.vo.staged_reloc:
            return attempt(False)
        res_w = attempt(True)

        def fallback(_):
            res_g = attempt(False)
            return _tree_where(
                res_g[2]["num_inliers"] > res_w[2]["num_inliers"],
                res_g, res_w)

        return jax.lax.cond(
            res_w[2]["num_inliers"] < 20, fallback, lambda _: res_w, None)

    idx, mvalid, out = jax.lax.cond(
        state.last_tracking, track_branch, reloc_branch, None)

    if cfg.vo.track_two_pass:
        def second_pass(args):
            idx, mvalid, out = args
            idx2, mvalid2 = _match_to_map(
                feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
                cam=cam, R=out["R"], t=out["t"], radius_px=8.0)
            out2 = _track_pnp(cam, feats, state.map, idx2, mvalid2,
                              out["R"], out["t"],
                              iters=cfg.vo.pnp_iters,
                              inlier_px=cfg.vo.pnp_inlier_px)
            better = (jnp.sum(mvalid2) >= jnp.sum(mvalid)) & (
                out2["num_inliers"] >= out["num_inliers"])
            return _tree_where(better, (idx2, mvalid2, out2),
                               (idx, mvalid, out))

        n1 = out["num_inliers"]
        idx, mvalid, out = jax.lax.cond(
            (n1 >= 15) & (n1 < cfg.vo.second_pass_below),
            second_pass, lambda a: a, (idx, mvalid, out))

    n_in = out["num_inliers"]
    pose_finite = (jnp.all(jnp.isfinite(out["R"]))
                   & jnp.all(jnp.isfinite(out["t"])))
    tracking = (n_in >= 20) & pose_finite & (
        out["rmse"] < 3.0 * cfg.vo.pnp_inlier_px)

    # Accept: update pose + low-passed constant-velocity model.  After a
    # RELOC accept the previous pose was stale (that's why we relocalized),
    # so the frame-to-frame delta is bogus — reset the velocity instead
    # (mirrors models/vo.py).
    Ri, ti = se3_inverse(state.R, state.t)
    Rv_new, tv_new = se3_compose(out["R"], out["t"], Ri, ti)
    xi = 0.6 * se3_log(Rv_new, tv_new) + 0.4 * se3_log(state.vel_R, state.vel_t)
    vel_R_acc, vel_t_acc = se3_exp(xi)
    vel_id_R, vel_id_t = se3_identity()
    use_vel = tracking & state.last_tracking
    state = state.replace(
        R=jnp.where(tracking, out["R"], state.R),
        t=jnp.where(tracking, out["t"], state.t),
        vel_R=jnp.where(use_vel, vel_R_acc, vel_id_R),
        vel_t=jnp.where(use_vel, vel_t_acc, vel_id_t),
        last_tracking=tracking,
        frames_since_kf=state.frames_since_kf + 1,
        frame_idx=state.frame_idx + 1,
    )

    need_kf = tracking & (
        (state.frames_since_kf >= cfg.vo.keyframe_max_interval)
        | ((n_in < cfg.vo.keyframe_min_inliers)
           & (state.frames_since_kf >= cfg.vo.keyframe_min_interval))
        | (n_in < cfg.vo.keyframe_critical_inliers))
    state = jax.lax.cond(
        need_kf,
        lambda s: _insert_keyframe(cam, cfg, s, feats, mvalid, out["inliers"]),
        lambda s: s,
        state)

    summary = jnp.stack([
        feats.count.astype(jnp.float32),
        jnp.sum(mvalid).astype(jnp.float32),
        n_in.astype(jnp.float32),
        tracking.astype(jnp.float32),
        need_kf.astype(jnp.float32),
        jnp.sum(state.map.valid).astype(jnp.float32),
        out["rmse"],
        state.threshold,
    ])
    return state, {"R": state.R, "t": state.t, "summary": summary}


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_chunk(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                images: jax.Array, active: jax.Array):
    """Track a (B, H, W) chunk of frames in ONE dispatch.

    `active` (B,) bool masks padding frames at the tail of a sequence:
    an inactive step is an identity on the carry (the whole point of the
    fixed chunk size is one compiled executable for any sequence length).
    """

    def step(state, xs):
        image, act = xs
        new_state, ys = jax.lax.cond(
            act,
            lambda s: track_step(cam, cfg, s, image),
            lambda s: (s, {"R": s.R, "t": s.t,
                           "summary": jnp.zeros((len(SUMMARY_FIELDS),),
                                                jnp.float32)}),
            state)
        return new_state, ys

    return jax.lax.scan(step, state, (images, active))


@dataclass
class DeviceVO:
    """Host shell around the device-resident tracker.

    Bootstrap (two-view initialization) is rare, host-decision-heavy and
    latency-irrelevant, so it reuses the host-driven VisualOdometry; once
    the map exists, tracking switches to chunked on-device scans.

    Usage::

        vo = DeviceVO(cfg, camera, chunk=16)
        for frame in frames:
            vo.process(frame)      # buffered; dispatched per chunk
        vo.flush()
        traj = vo.positions        # (T, 3) camera centers
    """

    cfg: SlamConfig
    camera: PinholeCamera
    chunk: int = 16

    def __post_init__(self):
        if not isinstance(self.cfg, SlamConfig):
            raise TypeError("cfg must be a SlamConfig")
        if self.chunk > KF_RING:
            raise ValueError(
                f"chunk={self.chunk} exceeds the keyframe feature ring "
                f"(KF_RING={KF_RING}); keyframes could be overwritten "
                "before the host syncs them")
        self._host = VisualOdometry(self.cfg, self.camera)
        self.state: VOState | None = None
        self._buf: list[jax.Array] = []
        self._pending: list[tuple[int, dict]] = []  # (n_active, lazy ys)
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self.stats: list[VOStats] = []
        self._frame_idx = -1
        # Submap chaining (r5): when relocalization fails for
        # cfg.vo.reloc_max_frames straight frames the tracker abandons the
        # stale pose and re-seeds a FRESH submap anchored at the last known
        # global pose (ORB-SLAM3's Atlas does the same).  `_base` maps the
        # global world frame to the CURRENT bootstrap's world frame; device
        # state is always kept global (the base is folded in at lift time).
        self._base: tuple[np.ndarray, np.ndarray] = (
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self._host_frame0 = 0       # global frame of host-local frame 0
        self.host_frames = 0        # frames processed on the host path
        self._lost_streak = 0
        self.num_reboots = 0
        self.submap_events: list[dict] = []
        # Called just before a reboot discards device state (the SLAM layer
        # uses it to pull not-yet-synced keyframes out of the window).
        self.pre_reboot_hook = None

    # -------- submap chaining --------
    def _apply_base_to_host(self):
        """Fold the submap base transform into the freshly-bootstrapped
        host tracker so every pose/point it hands over is GLOBAL.

        T_base: global world -> submap world; a submap pose T_l maps
        submap world -> camera, so the global pose is T_l o T_base and a
        submap point X_l lifts to X_g = R_b^T (X_l - t_b).  (Identity on
        the first bootstrap.)"""
        R_b, t_b = self._base
        if np.allclose(R_b, np.eye(3)) and np.allclose(t_b, 0.0):
            return
        h = self._host
        Rb = jnp.asarray(R_b)
        tb = jnp.asarray(t_b)
        h.win_R, h.win_t = (
            jnp.einsum("kij,jl->kil", h.win_R, Rb),
            jnp.einsum("kij,j->ki", h.win_R, tb) + h.win_t,
        )
        h.R, h.t = se3_compose(h.R, h.t, Rb, tb)
        h.kf_pose = se3_compose(*h.kf_pose, Rb, tb)
        h.kf_poses_log = [
            (k, np.asarray(R @ R_b), np.asarray(R @ t_b + t))
            for k, R, t in h.kf_poses_log
        ]
        h.map = h.map.replace(
            X=jnp.where(h.map.valid[:, None], (h.map.X - tb) @ Rb, h.map.X))
        self._base = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

    def _reboot(self):
        """Relocalization has failed for cfg.vo.reloc_max_frames straight
        frames: drop the stale submap state and re-seed a fresh bootstrap
        anchored at the last known global pose.  The new submap's monocular
        scale is re-normalized at bootstrap (a scale break the pose graph
        can absorb later through a Sim(3) loop edge)."""
        self._drain()
        if self.pre_reboot_hook is not None:
            self.pre_reboot_hook()
        if self.trajectory:
            R_last, t_last = self.trajectory[-1]
            self._base = (np.asarray(R_last, np.float32).copy(),
                          np.asarray(t_last, np.float32).copy())
        self.state = None
        # reset(), not a fresh instance: the host tracker's per-instance
        # jitted callables (frontend extract, adaptive threshold) survive,
        # so a reboot costs one two-view bootstrap, not a full re-trace of
        # the host pipeline.
        self._host.reset()
        self._host_frame0 = self._frame_idx + 1
        self._lost_streak = 0
        self.num_reboots += 1
        self.submap_events.append(
            {"frame": self._frame_idx, "base": self._base})

    # -------- bootstrap state handoff --------
    def _lift_state(self) -> VOState:
        h = self._host
        cap = self.cfg.frontend.max_features
        slot_feats = [
            f if f is not None else Features.empty(cap) for f in h.win_feats
        ]
        win_feats = jax.tree.map(
            lambda *xs: jnp.stack(xs, axis=0), *slot_feats)
        # Seed the keyframe ring from the host phase (kf0 + window slots).
        empty = Features.empty(cap)
        kf_ring = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (KF_RING, *x.shape)).copy(),
            empty)
        ring_entries = {}
        if h.kf0_feats is not None:
            ring_entries[0] = h.kf0_feats
        for slot in range(len(h.win_valid)):
            if h.win_valid[slot] and h.win_feats[slot] is not None:
                ring_entries[int(h.win_kf_id[slot])] = h.win_feats[slot]
        for kf_id, f in ring_entries.items():
            kf_ring = jax.tree.map(
                lambda w, x: w.at[kf_id % KF_RING].set(x), kf_ring, f)
        return VOState(
            map=h.map,
            win_R=h.win_R, win_t=h.win_t,
            win_obs=h.win_obs, win_mask=h.win_mask,
            win_valid=jnp.asarray(h.win_valid),
            win_kf_id=jnp.asarray(h.win_kf_id, jnp.int32),
            win_feats=win_feats,
            kf_ring=kf_ring,
            R=h.R, t=h.t,
            vel_R=h.vel[0], vel_t=h.vel[1],
            num_keyframes=jnp.int32(h.num_keyframes),
            frames_since_kf=jnp.int32(h.frames_since_kf),
            frame_idx=jnp.int32(h.frame_idx + 1),
            last_tracking=jnp.asarray(
                bool(h.stats[-1].tracking) if h.stats else True),
            threshold=jnp.asarray(h.frontend._threshold, jnp.float32),
        )

    # -------- frame ingestion --------
    def process(self, image) -> None:
        """Queue one frame.  Until bootstrap completes this runs the host
        path synchronously; afterwards frames are buffered and tracked in
        device chunks (use flush() to force out a partial chunk)."""
        self._frame_idx += 1
        if self.state is None:
            self.host_frames += 1
            st = self._host.process(image)
            R_l, t_l = self._host.trajectory[-1]
            R_b, t_b = self._base
            self.trajectory.append(
                (np.asarray(R_l) @ R_b, np.asarray(R_l) @ t_b + t_l))
            self.stats.append(st)
            if self._host.initialized:
                self._apply_base_to_host()
                self.state = self._lift_state()
            return
        # Keep HOST-side frames host-side until the chunk dispatch: one
        # stacked upload per chunk instead of `chunk` separate transfers.
        self._buf.append(image if isinstance(image, np.ndarray)
                         else jnp.asarray(image))
        if len(self._buf) >= self.chunk:
            self._dispatch()

    def _dispatch(self):
        n = len(self._buf)
        if n == 0:
            return
        B = self.chunk
        buf = self._buf + [self._buf[-1]] * (B - n)
        if all(isinstance(im, np.ndarray) for im in buf):
            images = jnp.asarray(np.stack(buf))
        else:
            images = jnp.stack([jnp.asarray(im) for im in buf])
        active = jnp.asarray([True] * n + [False] * (B - n))
        self._buf = []
        self.state, ys = track_chunk(self.camera, self.cfg, self.state,
                                     images, active)
        self._pending.append((n, ys))  # lazy: no readback here
        patience = self.cfg.vo.reloc_max_frames
        if patience > 0:
            # One small readback per CHUNK (not per frame): the tracking
            # flags, to detect unrecoverable loss.  Waits on this chunk's
            # compute, which the host loop would do at the next dispatch
            # anyway (the carry feeds it).
            flags = np.asarray(ys["summary"][:n, 3]) > 0.5
            for f in flags:
                self._lost_streak = 0 if f else self._lost_streak + 1
            if self._lost_streak >= patience:
                self._reboot()

    def flush(self):
        """Dispatch any partial chunk and materialize all pending summaries
        (the ONLY device->host synchronization point)."""
        self._dispatch()
        self._drain()

    def _drain(self):
        for n, ys in self._pending:
            R = np.asarray(ys["R"][:n])
            t = np.asarray(ys["t"][:n])
            s = np.asarray(ys["summary"][:n])
            base = len(self.stats)
            for i in range(n):
                self.trajectory.append((R[i], t[i]))
                self.stats.append(VOStats(
                    frame=base + i,
                    num_features=int(s[i, 0]), num_matches=int(s[i, 1]),
                    num_inliers=int(s[i, 2]), tracking=bool(s[i, 3]),
                    is_keyframe=bool(s[i, 4]), num_landmarks=int(s[i, 5]),
                    rmse_px=float(s[i, 6]),
                ))
        self._pending = []

    def run(self, images) -> list[VOStats]:
        for im in images:
            self.process(im)
        self.flush()
        return self.stats

    @property
    def initialized(self) -> bool:
        return self.state is not None

    @property
    def num_keyframes(self) -> int:
        if self.state is None:
            return self._host.num_keyframes
        return int(self.state.num_keyframes)

    @property
    def map(self):
        """Landmark slotmap (device-resident once initialized)."""
        return self._host.map if self.state is None else self.state.map

    @property
    def force_reloc(self) -> bool:
        """Crash-recovery hook (utils/faults.SnapshotPolicy): setting True
        forces global relocalization on the next tracked frame.  On-device
        the trigger IS ``last_tracking`` — the reloc branch of track_step."""
        if self.state is None:
            return self._host.force_reloc
        return not bool(self.state.last_tracking)

    @force_reloc.setter
    def force_reloc(self, value: bool) -> None:
        if self.state is None:
            self._host.force_reloc = bool(value)
        elif value:
            self.state = self.state.replace(last_tracking=jnp.asarray(False))

    @property
    def positions(self) -> np.ndarray:
        """Camera centers (world frame); call flush() first."""
        out = [-R.T @ t for R, t in self.trajectory]
        return np.asarray(out)
