"""Full SLAM: visual odometry + place recognition + Sim(3) pose-graph loop
closure (BASELINE config 5).

Loop measurement (scale-drift-aware, Strasdat-style): a loop candidate is
verified by PnP-ing the CURRENT keyframe against OLD-epoch landmarks
(reached through descriptor chains cur feature -> old-KF feature -> old
landmark).  That pose is expressed in the OLD map gauge, so comparing the
depths of the same scene under it vs under the drifted odometry pose
measures the relative scale s_e of the new local map w.r.t. the old one —
the 7th residual dimension the SE(3) graph cannot see.  All per-candidate
work (2 matchers + PnP-RANSAC + depth statistics, for BOTH candidates) is
ONE jitted dispatch with ONE packed readback (`_loop_probe`).

After the Sim(3) solve, corrections are applied as similarities: keyframe
SE(3) poses become (R, t/s); each landmark moves (and RESCALES) with the
keyframe that created it:  X' = S_anchor_new^-1 ( T_anchor_old X ).
"""

from __future__ import annotations

import contextlib
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tinyslam.config import SlamConfig
from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.se3 import se3_compose, se3_inverse
from tinyslam.geometry.sim3 import (
    sim3_compose,
    sim3_inverse,
    sim3_to_se3,
)
from tinyslam.models.vo import VisualOdometry, _match_to_map
from tinyslam.ops.hamming import match_descriptors
from tinyslam.types import Features, descriptor_signs


@jax.jit
def _kf_signature(feats: Features) -> jax.Array:
    """Cheap global descriptor: mean of valid BRIEF sign vectors (256,).
    A poor-man's bag-of-words prefilter for place recognition."""
    signs = descriptor_signs(feats.desc).astype(jnp.float32)
    w = feats.valid.astype(jnp.float32)[:, None]
    return jnp.sum(signs * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)


@functools.partial(jax.jit, static_argnames=("max_distance", "ratio"))
def _kf_ingest(cam: PinholeCamera, feats: Features, map_state,
               R: jax.Array, t: jax.Array,
               max_distance: int, ratio: float):
    """Fused per-keyframe ingest: landmark association (guided by the
    keyframe's own pose) + place-recognition signature in ONE dispatch —
    each separate jitted call costs a dispatch and a host sync.

    The association ships as a 3D SNAPSHOT (per-feature landmark position
    frozen at keyframe creation) rather than live-map indices: the loop
    probe's old-gauge geometry then survives landmark culling, slot reuse
    and submap reboots (r5: DeviceVO discards the whole map when it
    re-seeds a submap — index associations into a discarded map would be
    garbage, a snapshot is forever valid in its own gauge)."""
    idx, ok = _match_to_map(feats, map_state, max_distance, ratio,
                            cam=cam, R=R, t=t)
    return map_state.X[idx], ok & map_state.valid[idx], _kf_signature(feats)


@jax.jit
def _reanchor_landmarks(X, anchor_kf, valid, R_old, t_old, R_new, t_new,
                        s_new=None):
    """Move landmarks with their anchor keyframe's correction.

    R_old/t_old: (KF_total, 3, 3)/(KF_total, 3) SE(3) pose tables before the
    solve; R_new/t_new/s_new: the solved Sim(3) nodes.  The landmark rides
    the similarity  X' = S_new^-1 ( T_old X ): with s_new != 1 it both moves
    AND rescales — absorbing monocular scale drift into the map (s_new=None
    keeps the old rigid SE(3) behaviour)."""
    a = jnp.clip(anchor_kf, 0, R_old.shape[0] - 1)
    Ro, to = R_old[a], t_old[a]                       # (M, 3, 3), (M, 3)
    Rn, tn = R_new[a], t_new[a]
    # camera-frame coords under old pose, re-expressed via new (sim3) pose:
    Xc = jnp.einsum("mij,mj->mi", Ro, X) + to
    Rni = jnp.swapaxes(Rn, -1, -2)
    Xw = jnp.einsum("mij,mj->mi", Rni, Xc - tn)
    if s_new is not None:
        Xw = Xw / jnp.maximum(s_new[a], 1e-6)[:, None]
    return jnp.where(valid[:, None], Xw, X)


@functools.partial(jax.jit, static_argnames=(
    "max_distance", "ratio", "num_hypotheses", "pnp_iters", "inlier_px"))
def _loop_probe(
    cam: PinholeCamera,
    cur: Features,            # current keyframe features
    old_feats: Features,      # (C, ...) stacked candidate keyframe features
    old_ids: jax.Array,       # (C,) int32 candidate keyframe ids (GLOBAL)
    old_lm_X: jax.Array,      # (C, cap, 3) landmark snapshot per old feature
    old_lm_valid: jax.Array,  # (C, cap) association validity
    map_state,                # MapState (current submap)
    anchor_offset: jax.Array,  # () int32 — global id of local anchor_kf 0
    R_cur: jax.Array, t_cur: jax.Array,   # drifted odometry pose of cur KF
    kf_id: jax.Array,         # () int32 — current keyframe id (global)
    max_distance: int, ratio: float,
    num_hypotheses: int, pnp_iters: int, inlier_px: float,
) -> dict:
    """Batched loop-closure measurement: for each of the C candidates, ONE
    dispatch computes appearance verification, the old-gauge PnP of the
    CURRENT keyframe, and the relative-scale estimate.  The host reads back
    a single packed summary (VERDICT r3 next-step #3: the per-candidate
    match+PnP sequence with interleaved scalar readbacks was the full-SLAM
    fps bottleneck).

    The old-gauge 3D comes from per-keyframe SNAPSHOTS (kf_assoc), so the
    probe works across submap reboots — the old keyframe's map may no
    longer exist, its snapshot still measures its gauge.
    """
    from tinyslam.geometry.pnp import pnp_ransac

    def depths(R, t, X):
        return (X @ R.T + t)[..., 2]

    # New-gauge association of cur (shared across candidates): landmarks the
    # drifted pose projects nearby — the "recent map" side of the ratio.
    idx_n, val_n = _match_to_map(
        cur, map_state, max_distance, ratio, cam=cam, R=R_cur, t=t_cur)
    z_new = depths(R_cur, t_cur, map_state.X[idx_n])
    anchor_global = map_state.anchor_kf + anchor_offset

    def one(old_f: Features, old_id: jax.Array, old_X: jax.Array,
            old_lm_ok: jax.Array):
        # Appearance check: cur descriptors vs the old keyframe's.
        m = match_descriptors(
            cur.desc, cur.valid, old_f.desc, old_f.valid,
            max_distance=max_distance, ratio=ratio, cross_check=True)
        n_appear = jnp.sum(m["valid"].astype(jnp.int32))
        # Chain: cur i -> old j = m.idx_b[i] -> the 3D point the old
        # keyframe ASSOCIATED AT CREATION (kf_assoc snapshot, old gauge).
        X_chain = old_X[m["idx_b"]]                       # (N, 3)
        chain = m["valid"] & old_lm_ok[m["idx_b"]]
        # Absolute pose of CUR in the old gauge.  RANSAC, not refine-only:
        # under real scale drift the odometry pose can be outside the GN
        # convergence basin (the prior still rides along as one hypothesis).
        key = jax.random.fold_in(jax.random.PRNGKey(23), kf_id * 131 + old_id)
        out = pnp_ransac(
            cam, X_chain, cur.xy, chain, key,
            num_hypotheses=num_hypotheses, inlier_px=inlier_px,
            refine_iters=pnp_iters, R_prior=R_cur, t_prior=t_cur)
        # Relative scale: same camera, same scene — depth under the drifted
        # pose (new gauge) over depth under the old-gauge PnP pose.
        # Primary estimator: per-feature ratio where BOTH associations
        # exist (tightest).  Fallback: ratio of the two sides' median scene
        # depths (same camera, same field of view, so the medians compare
        # the same scene even when the feature sets barely intersect — the
        # strict intersection is often just a handful of features).
        z_old = depths(out["R"], out["t"], X_chain)
        recent = anchor_global[idx_n] > old_id
        old_ok = chain & out["inliers"] & (z_old > 1e-3)
        new_ok = val_n & recent & (z_new > 1e-3)
        both = old_ok & new_ok
        ratio_sn = jnp.where(both, z_new / jnp.maximum(z_old, 1e-6), jnp.nan)
        s_pair = jnp.nanmedian(ratio_sn)
        med_new = jnp.nanmedian(jnp.where(new_ok, z_new, jnp.nan))
        med_old = jnp.nanmedian(jnp.where(old_ok, z_old, jnp.nan))
        s_med = med_new / jnp.maximum(med_old, 1e-6)
        return {
            "n_appear": n_appear,
            "n_chain": jnp.sum(chain.astype(jnp.int32)),
            "num_inliers": out["num_inliers"].astype(jnp.int32),
            "rmse": out["rmse"],
            "R": out["R"], "t": out["t"],
            "s_e": s_pair,
            "n_scale_pairs": jnp.sum(both.astype(jnp.int32)),
            "s_e_med": s_med,
            "n_scale_old": jnp.sum(old_ok.astype(jnp.int32)),
            "n_scale_new": jnp.sum(new_ok.astype(jnp.int32)),
        }

    # Unrolled over the (small, static) candidate count: one fused dispatch.
    C = old_ids.shape[0]
    outs = [one(jax.tree.map(lambda x: x[c], old_feats), old_ids[c],
                old_lm_X[c], old_lm_valid[c])
            for c in range(C)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)


class Slam:
    """VO + loop closure.  Use exactly like VisualOdometry.

    With ``async_backend=True`` the pose-graph solve runs on a worker
    thread (parallel/pipeline.py, the PP analog of SURVEY §2d): tracking
    never blocks on global optimization; the correction is applied at the
    first frame boundary after the solve finishes.  Call ``finalize()``
    (or ``run()``, which does) to flush a pending solve at sequence end.
    """

    def __init__(self, cfg: SlamConfig, camera: PinholeCamera,
                 async_backend: bool = False,
                 solve_timeout_s: float = 30.0, **vo_kwargs):
        self.cfg = cfg
        self.camera = camera
        self.vo = VisualOdometry(cfg, camera, **vo_kwargs)
        self.kf_store: list[Features] = []       # per-KF features
        # Per-KF feature->landmark 3D SNAPSHOT, frozen at keyframe creation
        # (X (cap, 3), ok (cap,)): the loop probe's old-gauge 3D comes from
        # these — re-matching old features against the CURRENT map decays
        # with descriptor refresh and drift (measured: ~20 chain survivors
        # of ~150 appearance matches), and a position snapshot survives
        # landmark culling, slot reuse and submap reboots (r5) where a
        # live-map index would dangle.  Snapshots ride their keyframe's
        # Sim(3) correction whenever the pose graph is applied.
        self.kf_assoc: list[tuple[np.ndarray, np.ndarray]] = []
        self.kf_signatures: list[np.ndarray] = []
        self.kf_R: list[np.ndarray] = []         # running best pose per KF
        self.kf_t: list[np.ndarray] = []
        self.kf_frame_of: dict[int, int] = {}    # kf id -> global frame
        # Sim(3) edges: (i, j, R, t, s, weight) measuring S_j o S_i^-1
        # (odometry edges carry s = 1).
        self.edges: list[tuple[int, int, np.ndarray, np.ndarray, float, float]] = []
        self.num_loop_closures = 0
        # Every evaluated loop candidate, for offline gate tuning
        # (tools/error_budget.py measures precision/recall from this).
        self.loop_log: list[dict] = []
        # Wall-clock budget by stage (seconds), for the eval artifact:
        # where full-SLAM time goes (track dispatch / flush / kf ingest /
        # loop probe / graph solve).
        self.timings: dict[str, float] = {}
        self._worker = None
        if async_backend:
            # Supervised worker (utils/faults.Watchdog): a crashed or hung
            # pose-graph solve is detected at the next frame boundary and the
            # worker is rebuilt + the solve resubmitted — tracking never
            # blocks on (or dies with) the back-end.
            from tinyslam.utils.faults import Watchdog

            self._worker = Watchdog(solve_timeout_s=solve_timeout_s)

    @contextlib.contextmanager
    def _timed(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[key] = (self.timings.get(key, 0.0)
                                 + time.perf_counter() - t0)

    # ------------- keyframe bookkeeping -------------
    def _sync_new_keyframes(self):
        """Pull keyframes created by the VO layer since the last call."""
        while len(self.kf_store) < self.vo.num_keyframes:
            kf_id = len(self.kf_store)
            # The VO logs (kf_id, R, t) in order; features: the keyframe's
            # own window slot (NOT a kf_feats fallback, which is the NEWEST
            # keyframe's features — wrong for mid-window ids).
            _, R, t = self.vo.kf_poses_log[kf_id]
            if kf_id < len(self.vo.kf_frames_log):
                self.kf_frame_of[kf_id] = self.vo.kf_frames_log[kf_id]
            slots = np.nonzero(
                np.asarray(self.vo.win_valid)
                & (np.asarray(self.vo.win_kf_id) == kf_id))[0]
            if len(slots) and self.vo.win_feats[int(slots[0])] is not None:
                feats = self.vo.win_feats[int(slots[0])]
            elif kf_id == 0 and self.vo.kf0_feats is not None:
                feats = self.vo.kf0_feats
            else:
                feats = self.vo.kf_feats
            self._append_keyframe(kf_id, R, t, feats)

    def _append_keyframe(self, kf_id: int, R, t, feats: Features,
                         edge_weight: float = 1.0):
        assert kf_id == len(self.kf_store)
        self.kf_R.append(np.asarray(R))
        self.kf_t.append(np.asarray(t))
        self.kf_store.append(feats)
        # Freeze this keyframe's feature->landmark 3D snapshot (guided by
        # its own pose against the map as it exists NOW, i.e. at creation)
        # and its signature — one fused dispatch, one packed readback.
        with self._timed("kf_ingest"):
            X, ok, sig = _kf_ingest(
                self.camera, feats, self.vo.map,
                jnp.asarray(self.kf_R[-1]), jnp.asarray(self.kf_t[-1]),
                max_distance=self.cfg.matcher.max_distance,
                ratio=self.cfg.matcher.ratio)
            X, ok, sig = jax.device_get((X, ok, sig))
        self.kf_assoc.append((X, ok))
        self.kf_signatures.append(sig)
        if kf_id > 0:
            Rp, tp = self.kf_R[kf_id - 1], self.kf_t[kf_id - 1]
            Ri, ti = se3_inverse(jnp.asarray(Rp), jnp.asarray(tp))
            Re, te = se3_compose(jnp.asarray(R), jnp.asarray(t), Ri, ti)
            self.edges.append((kf_id - 1, kf_id, np.asarray(Re),
                               np.asarray(te), 1.0, float(edge_weight)))
            self._detect_loop(kf_id)

    # ------------- loop closure -------------
    def _detect_loop(self, kf_id: int):
        pg = self.cfg.pose_graph
        if kf_id < pg.loop_min_gap:
            return
        if kf_id < getattr(self, "_loop_cooldown_until", 0):
            return
        sig = self.kf_signatures[kf_id]
        old_ids = np.arange(0, kf_id - pg.loop_min_gap + 1)
        if len(old_ids) == 0:
            return
        # Top-C place recognition as ONE (N_old, 256) x (256,) matmul over
        # the stacked signature matrix (r4 weak #7: a per-keyframe Python
        # loop of dots; the matrix form costs the same at N~100 and keeps
        # the search a single BLAS call at multi-sequence scale).
        sims = np.stack(self.kf_signatures[:len(old_ids)]) @ sig
        C = max(2, pg.loop_candidates)
        n_cand = min(C, len(old_ids))
        cand = old_ids[np.argsort(-sims)[:n_cand]].astype(np.int32)
        if n_cand < C:                  # static probe shape: pad by repeat
            cand = np.concatenate([cand, np.repeat(cand[:1], C - n_cand)])
        cur = self.kf_store[kf_id]
        old_stack = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[self.kf_store[int(c)] for c in cand])
        old_lm_X = jnp.asarray(np.stack(
            [self.kf_assoc[int(c)][0] for c in cand]))
        old_ok = jnp.asarray(np.stack(
            [self.kf_assoc[int(c)][1] for c in cand]))
        # ONE dispatch for both candidates; ONE packed readback.
        with self._timed("loop_probe"):
            probe = _loop_probe(
                self.camera, cur, old_stack, jnp.asarray(cand),
                old_lm_X, old_ok,
                self.vo.map, jnp.int32(self._anchor_offset()),
                jnp.asarray(self.kf_R[kf_id]), jnp.asarray(self.kf_t[kf_id]),
                jnp.int32(kf_id),
                max_distance=self.cfg.matcher.max_distance,
                ratio=self.cfg.matcher.ratio,
                num_hypotheses=self.cfg.vo.reloc_hypotheses,
                pnp_iters=self.cfg.vo.pnp_iters,
                inlier_px=self.cfg.vo.pnp_inlier_px,
            )
            probe = jax.tree.map(np.asarray, probe)
        seen = set()
        for c in range(len(cand)):
            old = int(cand[c])
            if old in seen:
                continue
            seen.add(old)
            n_in = int(probe["num_inliers"][c])
            n_chain = max(int(probe["n_chain"][c]), 1)
            rmse = float(probe["rmse"][c])
            rec = {
                "kf": kf_id, "old": old,
                "n_appear": int(probe["n_appear"][c]),
                "n_chain": n_chain, "num_inliers": n_in, "rmse": rmse,
                "s_e": float(probe["s_e"][c]),
                "n_scale_pairs": int(probe["n_scale_pairs"][c]),
                "s_e_med": float(probe["s_e_med"][c]),
                "n_scale_old": int(probe["n_scale_old"][c]),
                "n_scale_new": int(probe["n_scale_new"][c]),
                "accepted": False,
            }
            self.loop_log.append(rec)
            if int(probe["n_appear"][c]) < pg.loop_min_matches:
                continue
            if (n_in < pg.loop_min_matches
                    or n_in / n_chain < pg.loop_min_inlier_ratio
                    or not np.isfinite(rmse)
                    or rmse > pg.loop_max_rmse_px):
                continue
            rec["accepted"] = True
            # Relative scale of the new local map w.r.t. the old gauge:
            # per-feature ratio when enough pairs support it, else the
            # median-of-medians fallback, else no scale information (1.0).
            # The fallback compares medians of two different landmark
            # subsets, so it is biased when their spatial distributions
            # differ (ADVICE r4) — an edge built on it ships at reduced
            # weight.
            s_e = float(probe["s_e"][c])
            weight = 5.0
            if (int(probe["n_scale_pairs"][c]) < pg.loop_min_scale_pairs
                    or not np.isfinite(s_e)):
                s_e = float(probe["s_e_med"][c])
                weight = 2.0
                if (min(int(probe["n_scale_old"][c]),
                        int(probe["n_scale_new"][c])) < pg.loop_min_scale_pairs
                        or not np.isfinite(s_e)):
                    s_e = 1.0
            if not (0.2 < s_e < 5.0):
                s_e = 1.0
            # Sim(3) edge old -> new:  S_m = S_new_meas o S_old_meas^-1 with
            # S_old = (R_old, t_old, 1) (old gauge) and S_new = the old-gauge
            # PnP pose at local scale s_e, i.e. (R', s_e t', s_e).
            Rn = jnp.asarray(probe["R"][c])
            tn = jnp.asarray(probe["t"][c]) * s_e
            sn = jnp.asarray(s_e, jnp.float32)
            Ro = jnp.asarray(self.kf_R[int(old)])
            to = jnp.asarray(self.kf_t[int(old)])
            so = jnp.asarray(1.0, jnp.float32)
            Re, te, se = sim3_compose(Rn, tn, sn,
                                      *sim3_inverse(Ro, to, so))
            self.edges.append((int(old), kf_id, np.asarray(Re),
                               np.asarray(te), float(se), weight))
            self.num_loop_closures += 1
            self._loop_cooldown_until = kf_id + 1 + pg.loop_cooldown
            self._optimize_graph()
            return

    def _optimize_graph(self):
        n = len(self.kf_R)
        if n < 3 or not self.edges:
            return
        snap = (np.stack(self.kf_R), np.stack(self.kf_t), list(self.edges))
        if self._worker is not None:
            # Latest-wins: a newer snapshot contains every edge of an older
            # one, so superseding a not-yet-started solve loses nothing.
            self._worker.submit(lambda: (snap, self._solve_graph(snap)))
        else:
            with self._timed("graph_solve"):
                self._apply_graph_result(snap, self._solve_graph(snap))

    def _solve_graph(self, snap):
        """Device compute only — safe on the worker thread.  Returns the
        solved Sim(3) nodes (R, t, s); with cfg.pose_graph.sim3 = False the
        SE(3) solver runs and s is all-ones.

        Nodes/edges are PADDED to quantized capacities (validity-masked):
        without padding every solve has a brand-new static shape (the graph
        grows monotonically) and XLA recompiles per loop closure — seconds
        each, the dominant full-SLAM latency term."""
        from tinyslam.backend.pose_graph import (
            optimize_pose_graph,
            optimize_pose_graph_sim3,
        )

        R_old, t_old, edges = snap
        n = len(R_old)
        E = len(edges)
        n_pad = min(-(-max(n, 1) // 32) * 32, self.cfg.pose_graph.max_nodes)
        n_pad = max(n_pad, n)
        e_pad = min(-(-max(E, 1) // 128) * 128, self.cfg.pose_graph.max_edges)
        e_pad = max(e_pad, E)
        Rp = np.tile(np.eye(3, dtype=np.float32)[None], (n_pad, 1, 1))
        tp = np.zeros((n_pad, 3), np.float32)
        Rp[:n] = R_old
        tp[:n] = t_old
        node_valid = np.zeros(n_pad, bool)
        node_valid[:n] = True
        ei = np.zeros(e_pad, np.int32)
        ej = np.zeros(e_pad, np.int32)
        eR = np.tile(np.eye(3, dtype=np.float32)[None], (e_pad, 1, 1))
        et = np.zeros((e_pad, 3), np.float32)
        es = np.ones(e_pad, np.float32)
        ew = np.ones(e_pad, np.float32)
        ev = np.zeros(e_pad, bool)
        for k, e in enumerate(edges):
            ei[k], ej[k], eR[k], et[k], es[k], ew[k] = e
            ev[k] = True
        if self.cfg.pose_graph.sim3:
            out = optimize_pose_graph_sim3(
                jnp.asarray(Rp), jnp.asarray(tp),
                jnp.ones((n_pad,), jnp.float32),
                jnp.asarray(ei), jnp.asarray(ej),
                jnp.asarray(eR), jnp.asarray(et), jnp.asarray(es),
                jnp.asarray(ev), jnp.asarray(ew),
                node_valid=jnp.asarray(node_valid),
                iters=self.cfg.pose_graph.gn_iters,
            )
            return (np.asarray(out["R"])[:n], np.asarray(out["t"])[:n],
                    np.asarray(out["s"])[:n])
        out = optimize_pose_graph(
            jnp.asarray(Rp), jnp.asarray(tp),
            jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(eR), jnp.asarray(et),
            jnp.asarray(ev), jnp.asarray(ew),
            node_valid=jnp.asarray(node_valid),
            iters=self.cfg.pose_graph.gn_iters,
        )
        return (np.asarray(out["R"])[:n], np.asarray(out["t"])[:n],
                np.ones(n, np.float32))

    @staticmethod
    def _extend_solution(snap, solved, kf_R, kf_t):
        """Common Sim(3) bookkeeping: extend the solved node tables to
        keyframes created while an async solve ran (carried by the newest
        snapshot node's similarity correction) and compute the corrected
        SE(3) pose tables.  Returns
        (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n)."""
        R_old, t_old, _ = snap
        R_sim, t_sim, s_sim = solved
        n = len(R_old)
        total = len(kf_R)
        # Similarity correction of the newest solved node.
        corr = sim3_compose(
            jnp.asarray(R_sim[n - 1]), jnp.asarray(t_sim[n - 1]),
            jnp.asarray(s_sim[n - 1]),
            *sim3_inverse(jnp.asarray(R_old[n - 1]),
                          jnp.asarray(t_old[n - 1]),
                          jnp.asarray(1.0, jnp.float32)),
        )
        if total > n:
            ext_old_R = np.stack(kf_R[n:])
            ext_old_t = np.stack(kf_t[n:])
            ext = [
                sim3_compose(*corr, jnp.asarray(r), jnp.asarray(tt),
                             jnp.asarray(1.0, jnp.float32))
                for r, tt in zip(ext_old_R, ext_old_t)
            ]
            R_old = np.concatenate([R_old, ext_old_R])
            t_old = np.concatenate([t_old, ext_old_t])
            R_sim = np.concatenate(
                [R_sim, np.stack([np.asarray(e[0]) for e in ext])])
            t_sim = np.concatenate(
                [t_sim, np.stack([np.asarray(e[1]) for e in ext])])
            s_sim = np.concatenate(
                [s_sim, np.stack([np.asarray(e[2]) for e in ext])])
            n = total
        R_se, t_se = sim3_to_se3(
            jnp.asarray(R_sim), jnp.asarray(t_sim), jnp.asarray(s_sim))
        return (R_old, t_old, R_sim, t_sim, s_sim,
                np.asarray(R_se), np.asarray(t_se), corr, n)

    def _anchor_offset(self) -> int:
        """Global keyframe id of the current submap's local anchor 0 (the
        host tracker never reboots, so 0; DeviceSlam overrides)."""
        return 0

    def _reanchor_assoc_snapshots(self, R_old, t_old, R_sim, t_sim, s_sim, n):
        """Ride each keyframe's Sim(3) correction into its kf_assoc 3D
        snapshot (the snapshots define the probe's old gauge — leaving them
        behind after a solve would make every later loop edge against a
        corrected keyframe measure a phantom offset)."""
        if n == 0 or not self.kf_assoc:
            return
        n = min(n, len(self.kf_assoc))
        cap = self.kf_assoc[0][0].shape[0]
        Xs = np.stack([self.kf_assoc[k][0] for k in range(n)])
        oks = np.stack([self.kf_assoc[k][1] for k in range(n)])
        anchor = np.repeat(np.arange(n, dtype=np.int32), cap)
        newX = np.asarray(_reanchor_landmarks(
            jnp.asarray(Xs.reshape(-1, 3)), jnp.asarray(anchor),
            jnp.asarray(oks.reshape(-1)),
            jnp.asarray(R_old[:n]), jnp.asarray(t_old[:n]),
            jnp.asarray(R_sim[:n]), jnp.asarray(t_sim[:n]),
            jnp.asarray(s_sim[:n]))).reshape(n, cap, 3)
        for k in range(n):
            self.kf_assoc[k] = (newX[k], oks[k])

    def _apply_graph_result(self, snap, solved):
        (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n) = (
            self._extend_solution(snap, solved, self.kf_R, self.kf_t))
        # Re-anchor landmarks with their keyframe similarity corrections.
        self.vo.map = self.vo.map.replace(
            X=_reanchor_landmarks(
                self.vo.map.X, self.vo.map.anchor_kf, self.vo.map.valid,
                jnp.asarray(R_old), jnp.asarray(t_old),
                jnp.asarray(R_sim), jnp.asarray(t_sim), jnp.asarray(s_sim),
            )
        )
        self._reanchor_assoc_snapshots(R_old, t_old, R_sim, t_sim, s_sim, n)
        # Update stored keyframe poses + the VO window + current pose.
        for i in range(n):
            self.kf_R[i] = R_se[i]
            self.kf_t[i] = t_se[i]
        for slot in range(len(self.vo.win_valid)):
            if self.vo.win_valid[slot]:
                kf_id = int(self.vo.win_kf_id[slot])
                if 0 <= kf_id < n:
                    self.vo.win_R = self.vo.win_R.at[slot].set(
                        jnp.asarray(R_se[kf_id]))
                    self.vo.win_t = self.vo.win_t.at[slot].set(
                        jnp.asarray(t_se[kf_id]))
        # Correct the live pose by the newest KF's similarity correction.
        live = sim3_compose(*corr, self.vo.R, self.vo.t,
                            jnp.asarray(1.0, jnp.float32))
        self.vo.R, self.vo.t = sim3_to_se3(*live)
        self.vo.kf_pose = (
            jnp.asarray(R_se[int(self.vo.win_kf_id[self._newest_slot()])]),
            jnp.asarray(t_se[int(self.vo.win_kf_id[self._newest_slot()])]),
        ) if self._newest_slot() is not None else self.vo.kf_pose

    def _newest_slot(self):
        nz = np.nonzero(self.vo.win_valid)[0]
        return int(nz.max()) if len(nz) else None

    # ------------- public API -------------
    def process(self, image):
        st = self.process_frame(image)
        return st

    def process_frame(self, image):
        with self._timed("track"):
            st = self.vo.process(image)
        # Keep Slam's per-KF pose log in sync with BA-refined window poses.
        self._sync_new_keyframes()
        self._refresh_window_poses()
        if self._worker is not None:
            res = self._worker.poll()
            if res is not None:
                self._apply_graph_result(*res)
        return st

    def finalize(self):
        """Apply any in-flight pose-graph solve (async mode); idempotent."""
        if self._worker is not None:
            res = self._worker.flush()
            if res is not None:
                self._apply_graph_result(*res)

    def close(self):
        if self._worker is not None:
            self._worker.close()
            self._worker = None

    def _refresh_window_poses(self):
        for slot in range(len(self.vo.win_valid)):
            if self.vo.win_valid[slot]:
                kf_id = int(self.vo.win_kf_id[slot])
                if 0 <= kf_id < len(self.kf_R):
                    self.kf_R[kf_id] = np.asarray(self.vo.win_R[slot])
                    self.kf_t[kf_id] = np.asarray(self.vo.win_t[slot])

    def run(self, images):
        out = [self.process_frame(im) for im in images]
        self.finalize()
        return out

    def corrected_trajectory(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Dense trajectory with keyframe corrections propagated.

        The online per-frame trajectory is recorded BEFORE later window-BA
        refinement and pose-graph/loop corrections; those only update the
        keyframe tables (kf_R/kf_t).  Here every frame rides the correction
        of its most recent keyframe k:  T_f' = (T_f o T_k_raw^-1) o T_k_new
        — the standard dense-trajectory update after pose-graph optimization
        (without it an accepted loop closure cannot change the evaluated
        ATE at all, which is exactly what EVAL_r04 showed)."""
        traj = self.vo.trajectory
        # Exact kf -> frame map recorded at keyframe creation (an inferred
        # map mis-attributes corrections across bootstrap re-seeds and
        # submap reboots, which makes the "corrected" trajectory worse).
        kf_at = sorted((f, k) for k, f in self.kf_frame_of.items()
                       if k < len(self.kf_R) and f < len(traj))
        out = []
        j = -1                     # index into kf_at of latest kf <= f
        for f, (R, t) in enumerate(traj):
            while j + 1 < len(kf_at) and kf_at[j + 1][0] <= f:
                j += 1
            if j < 0:
                out.append((np.asarray(R), np.asarray(t)))
                continue
            fk, k = kf_at[j]
            R_raw, t_raw = (np.asarray(a) for a in traj[fk])
            R_f, t_f = np.asarray(R), np.asarray(t)
            R_rel = R_f @ R_raw.T
            t_rel = t_f - R_rel @ t_raw
            R_new, t_new = self.kf_R[k], self.kf_t[k]
            out.append((R_rel @ R_new, R_rel @ t_new + t_rel))
        return out

    @property
    def positions(self) -> np.ndarray:
        out = [-R.T @ t for R, t in self.corrected_trajectory()]
        return np.asarray(out)

    @property
    def trajectory(self):
        return self.corrected_trajectory()

    @property
    def raw_positions(self) -> np.ndarray:
        """Online (uncorrected) trajectory positions, for ablation."""
        return self.vo.positions


class DeviceSlam(Slam):
    """Slam over the device-resident chunked tracker (models/vo_device.py).

    The host-driven Slam makes ~12 device->host readbacks per frame; this
    variant tracks in ``lax.scan`` chunks (one dispatch + one readback per
    CHUNK) and runs the loop-closure layer at chunk boundaries:

    - after each chunk the new keyframes are pulled from the device window
      (``VOState.win_feats`` — their features live there, BA-refined poses
      included; the host Slam's `kf_feats`-fallback fragility is gone);
    - place recognition + pose-graph optimization run on the host/worker as
      in Slam (they are per-KEYFRAME, latency-tolerant work — the PP-analog
      split of SURVEY §2d);
    - corrections are applied functionally to the device state between
      chunks (landmark re-anchoring, window poses, live pose).

    Keyframe features are recovered from the window by kf_id; a keyframe
    that rolled out of the window within a single chunk (pathological
    keyframe churn) degrades gracefully: its pose comes from the tracked
    trajectory and its features are empty (it can seed no loop closures).
    """

    def __init__(self, cfg: SlamConfig, camera: PinholeCamera,
                 chunk: int = 16, async_backend: bool = False,
                 solve_timeout_s: float = 30.0):
        super().__init__(cfg, camera, async_backend=async_backend,
                         solve_timeout_s=solve_timeout_s)
        from tinyslam.models.vo_device import DeviceVO

        self.vo = DeviceVO(cfg, camera, chunk=chunk)
        self._synced_stats = 0          # stats entries scanned for keyframes
        self._kf_frame: dict[int, int] = {}   # kf_id -> frame index fallback
        # Global-keyframe-id offset of the current submap: the device
        # tracker restarts its local keyframe numbering (and its map's
        # anchor ids) at every reboot; the SLAM layer numbers keyframes
        # globally so the pose graph spans submaps (global = offset +
        # local).  The reboot hook pulls not-yet-synced keyframes out of
        # the device window before the state is discarded.
        self._kf_offset = 0
        self.vo.pre_reboot_hook = self._pre_reboot

    def _anchor_offset(self) -> int:
        return self._kf_offset

    # ------------- keyframe sync (chunk granularity) -------------
    def process_frame(self, image):
        vo = self.vo
        was_init = vo.state is not None
        pending_before = len(vo._pending)
        # Budget key distinguishes the (rare, expensive) host bootstrap
        # phase from steady chunked tracking.
        with self._timed("track" if was_init else "track_boot"):
            vo.process(image)
        if vo.state is not None and not was_init:
            self._sync_bootstrap()
        elif vo.state is not None and len(vo._pending) > pending_before:
            self._sync_chunk()
        return vo.stats[-1] if vo.stats else None

    def _pre_reboot(self):
        """DeviceVO is about to discard its state for a fresh submap: sync
        any keyframes still only in the device window."""
        self._sync_chunk()

    def _sync_bootstrap(self):
        """A bootstrap completed on the host tracker (initial or submap
        reboot); pull its two keyframes under GLOBAL ids.  Across a reboot
        the odometry edge into the first new keyframe runs through the
        stale lost-pose guess, so it ships at reduced weight."""
        h = self.vo._host
        self._kf_offset = len(self.kf_store)
        first_new = self._kf_offset > 0
        for kf_id, R, t in h.kf_poses_log:
            feats = h.kf0_feats if kf_id == 0 else h.kf_feats
            gid = self._kf_offset + kf_id
            self._append_keyframe(
                gid, R, t, feats,
                edge_weight=0.3 if (first_new and kf_id == 0) else 1.0)
            if kf_id < len(h.kf_frames_log):
                frame = self.vo._host_frame0 + h.kf_frames_log[kf_id]
                self._kf_frame[gid] = frame
                self.kf_frame_of[gid] = frame
        self._synced_stats = len(self.vo.stats)
        self._refresh_window_poses()

    def _sync_chunk(self):
        vo = self.vo
        with self._timed("flush"):
            vo.flush()                  # materialize pending summaries
        state = vo.state
        if state is None:
            return
        # Map device-phase keyframe stats to GLOBAL kf ids (pose fallback
        # for keyframes that rolled out of the window within one chunk).
        new_stats = vo.stats[self._synced_stats:]
        next_kf = (max(self._kf_frame) + 1) if self._kf_frame else len(
            self.kf_store)
        for i, s in enumerate(new_stats):
            if s.is_keyframe:
                self._kf_frame[next_kf] = self._synced_stats + i
                self.kf_frame_of[next_kf] = self._synced_stats + i
                next_kf += 1
        self._synced_stats = len(vo.stats)

        total = self._kf_offset + int(state.num_keyframes)
        if total > len(self.kf_store):
            from tinyslam.models.vo_device import KF_RING

            for gid in range(len(self.kf_store), total):
                # Re-read the device state EVERY iteration: a loop probe on
                # the previous keyframe may have accepted a closure and run
                # a synchronous graph solve, which REPLACES self.vo.state
                # with Sim(3)-corrected poses + a rescaled map — appending
                # the next keyframe from a stale pre-solve window snapshot
                # pairs an uncorrected pose with the corrected map and
                # every guided match against it comes back empty (measured:
                # n_scale_new = 0 on exactly the probes following an
                # accepted closure).
                state = vo.state
                win_kf = np.asarray(state.win_kf_id)
                win_valid = np.asarray(state.win_valid)
                local = gid - self._kf_offset
                # Features always come from the device keyframe ring —
                # immune to window rolling (VERDICT r3 weak #5); the pose
                # prefers the BA-refined window slot when still present.
                feats = jax.tree.map(
                    lambda x: x[local % KF_RING], state.kf_ring)
                slots = np.nonzero(win_valid & (win_kf == local))[0]
                if len(slots):
                    slot = int(slots[0])
                    R = np.asarray(state.win_R[slot])
                    t = np.asarray(state.win_t[slot])
                else:
                    frame = self._kf_frame.get(gid)
                    if frame is not None and frame < len(vo.trajectory):
                        R, t = vo.trajectory[frame]
                    else:
                        R, t = self.kf_R[-1], self.kf_t[-1]
                self._append_keyframe(gid, R, t, feats)
        self._refresh_window_poses()
        if self._worker is not None:
            res = self._worker.poll()
            if res is not None:
                self._apply_graph_result(*res)

    def _refresh_window_poses(self):
        state = self.vo.state
        if state is None:
            return
        win_valid = np.asarray(state.win_valid)
        win_kf = np.asarray(state.win_kf_id)
        win_R = np.asarray(state.win_R)
        win_t = np.asarray(state.win_t)
        for slot in range(len(win_valid)):
            gid = self._kf_offset + int(win_kf[slot])
            if win_valid[slot] and self._kf_offset <= gid < len(self.kf_R):
                self.kf_R[gid] = win_R[slot]
                self.kf_t[gid] = win_t[slot]

    # ------------- corrections into device state -------------
    def _apply_graph_result(self, snap, solved):
        state = self.vo.state
        (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n) = (
            self._extend_solution(snap, solved, self.kf_R, self.kf_t))
        for i in range(n):
            self.kf_R[i] = R_se[i]
            self.kf_t[i] = t_se[i]
        self._reanchor_assoc_snapshots(R_old, t_old, R_sim, t_sim, s_sim, n)
        if state is None:
            # Mid-reboot (host bootstrap phase): no device state to move;
            # the keyframe tables and snapshots above carry the correction.
            return
        # Landmark anchors are LOCAL to the current submap's numbering.
        anchor_global = state.map.anchor_kf + jnp.int32(self._kf_offset)
        new_X = _reanchor_landmarks(
            state.map.X, anchor_global, state.map.valid,
            jnp.asarray(R_old), jnp.asarray(t_old),
            jnp.asarray(R_sim), jnp.asarray(t_sim), jnp.asarray(s_sim))
        # One readback + one upload instead of 2K tiny .at[].set dispatches
        # (each costs a dispatch).
        win_R_np = np.array(state.win_R)
        win_t_np = np.array(state.win_t)
        win_valid = np.asarray(state.win_valid)
        win_kf = np.asarray(state.win_kf_id)
        for slot in range(len(win_valid)):
            gid = self._kf_offset + int(win_kf[slot])
            if win_valid[slot] and self._kf_offset <= gid < n:
                win_R_np[slot] = R_se[gid]
                win_t_np[slot] = t_se[gid]
        win_R = jnp.asarray(win_R_np)
        win_t = jnp.asarray(win_t_np)
        live = sim3_compose(*corr, state.R, state.t,
                            jnp.asarray(1.0, jnp.float32))
        live_R, live_t = sim3_to_se3(*live)
        self.vo.state = state.replace(
            map=state.map.replace(X=new_X),
            win_R=win_R, win_t=win_t, R=live_R, t=live_t,
        )

    def finalize(self):
        """Flush the tracker's partial chunk, sync stragglers, apply any
        in-flight pose-graph solve; idempotent."""
        if self.vo.state is not None:
            self._sync_chunk()
        else:
            self.vo.flush()
        super().finalize()
