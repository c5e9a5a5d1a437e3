"""Checkpoint / resume (SURVEY §5): the map, keyframe window and trajectory
are pytrees, saved as one ``.npz`` of their leaves (keyed by tree path) plus
JSON metadata for the host-side bookkeeping.  Resume = reload + continue
tracking (the re-localization against the restored map is the VO's normal
lost-recovery path).

The reference has no persistent state at all (the layer that would need it
was never built, reference README.md:53-57).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np

# Format history: v1 (unversioned) = SE(3)-only 5-tuple edges, index-based
# kf_lm_idx associations; v2 = Sim(3) 6-tuple edges + 3D-snapshot kf_lm_X
# associations + submap kf_offset, in a checkpoint library's directory
# layout; v3 = the v2 field set as .npz leaves + JSON, every metadata file
# carrying the version.
FORMAT_VERSION = 3


def _read_meta(path: Path) -> dict:
    """A metadata file, refused unless it is of FORMAT_VERSION."""
    meta = json.loads(path.read_text())
    version = meta.get("format_version", 1)
    if version != FORMAT_VERSION:
        raise ValueError(
            f"{path}: incompatible checkpoint format {version} (expected "
            f"{FORMAT_VERSION}).  v1 stored live-map landmark indices and v2 "
            "another directory layout; neither is migrated — re-run the "
            "sequence or restore with the matching framework version")
    return meta


def _save_tree(path: Path, tree) -> None:
    """Write every leaf of ``tree`` to ``path`` (.npz), keyed by tree path."""
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    np.savez(path, **{jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in leaves})


def _load_tree(path: Path, target):
    """Read a ``_save_tree`` file back into the structure of ``target``:
    each leaf must have the target leaf's shape and takes its dtype."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    out = []
    with np.load(path) as z:
        for k, ref in leaves:
            a = z[jax.tree_util.keystr(k)]
            if a.shape != np.shape(ref):
                raise ValueError(f"{path}: {jax.tree_util.keystr(k)} has shape"
                                 f" {a.shape}, expected {np.shape(ref)}")
            out.append(a.astype(np.asarray(ref).dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _vo_state_pytree(vo) -> dict:
    return {
        "map": {
            "X": vo.map.X,
            "desc": vo.map.desc,
            "valid": vo.map.valid,
            "anchor_kf": vo.map.anchor_kf,
            "obs_count": vo.map.obs_count,
            "last_seen": vo.map.last_seen,
        },
        "window": {
            "R": vo.win_R,
            "t": vo.win_t,
            "obs": vo.win_obs,
            "mask": vo.win_mask,
        },
        "pose": {"R": vo.R, "t": vo.t},
        "vel": {"R": vo.vel[0], "t": vo.vel[1]},
        "kf_pose": {"R": vo.kf_pose[0], "t": vo.kf_pose[1]},
        "kf_feats": _features_dict(
            vo.kf_feats
            if vo.kf_feats is not None
            else _empty_features(vo.cfg.frontend.max_features)
        ),
        # Per-window-slot keyframe features (None slots -> empty features;
        # presence recorded in meta.json so restore rebuilds the same list).
        "win_feats": [
            _features_dict(
                f if f is not None
                else _empty_features(vo.cfg.frontend.max_features))
            for f in vo.win_feats
        ],
    }


def _empty_features(capacity: int):
    from tinyslam.types import Features

    return Features.empty(capacity)


def _features_dict(f) -> dict:
    return {
        "xy": f.xy, "level": f.level, "angle": f.angle,
        "score": f.score, "desc": f.desc, "valid": f.valid,
    }


def save_vo(vo, path) -> None:
    """Checkpoint a VisualOdometry / DeviceVO (or Slam().vo) instance."""
    if hasattr(vo, "state"):                  # DeviceVO
        save_device_vo(vo, path)
        return
    path = Path(path).resolve()
    _save_tree(path / "arrays.npz", _vo_state_pytree(vo))
    meta = {
        "format_version": FORMAT_VERSION,
        "win_valid": np.asarray(vo.win_valid).tolist(),
        "win_kf_id": np.asarray(vo.win_kf_id).tolist(),
        "num_keyframes": vo.num_keyframes,
        "frame_idx": vo.frame_idx,
        "frames_since_kf": vo.frames_since_kf,
        "initialized": vo.initialized,
        "has_kf_feats": vo.kf_feats is not None,
        "win_feats_present": [f is not None for f in vo.win_feats],
        "frontend_threshold": vo.frontend.threshold,
        "trajectory": [
            [np.asarray(R).tolist(), np.asarray(t).tolist()]
            for R, t in vo.trajectory
        ],
    }
    (path / "meta.json").write_text(json.dumps(meta))


def restore_vo(vo, path) -> None:
    """Restore state saved by save_vo into a freshly-constructed instance
    (same config)."""
    import jax.numpy as jnp

    if hasattr(vo, "state"):                  # DeviceVO
        restore_device_vo(vo, path)
        return
    path = Path(path).resolve()
    meta = _read_meta(path / "meta.json")
    state = _load_tree(path / "arrays.npz", _vo_state_pytree(vo))
    from tinyslam.models.vo import MapState

    vo.map = MapState(
        X=jnp.asarray(state["map"]["X"]),
        desc=jnp.asarray(state["map"]["desc"]),
        valid=jnp.asarray(state["map"]["valid"]),
        anchor_kf=jnp.asarray(state["map"]["anchor_kf"]),
        obs_count=jnp.asarray(state["map"]["obs_count"]),
        last_seen=jnp.asarray(state["map"]["last_seen"]),
    )
    vo.win_R = jnp.asarray(state["window"]["R"])
    vo.win_t = jnp.asarray(state["window"]["t"])
    vo.win_obs = jnp.asarray(state["window"]["obs"])
    vo.win_mask = jnp.asarray(state["window"]["mask"])
    vo.R = jnp.asarray(state["pose"]["R"])
    vo.t = jnp.asarray(state["pose"]["t"])
    vo.vel = (jnp.asarray(state["vel"]["R"]), jnp.asarray(state["vel"]["t"]))
    vo.kf_pose = (
        jnp.asarray(state["kf_pose"]["R"]), jnp.asarray(state["kf_pose"]["t"])
    )

    from tinyslam.types import Features

    def _features_from(d):
        return Features(
            xy=jnp.asarray(d["xy"]), level=jnp.asarray(d["level"]),
            angle=jnp.asarray(d["angle"]), score=jnp.asarray(d["score"]),
            desc=jnp.asarray(d["desc"]), valid=jnp.asarray(d["valid"]),
        )

    if meta.get("has_kf_feats", False):
        vo.kf_feats = _features_from(state["kf_feats"])
    present = meta.get("win_feats_present", [False] * len(vo.win_feats))
    vo.win_feats = [
        _features_from(f) if p else None
        for f, p in zip(state["win_feats"], present)
    ]
    vo.win_valid = np.asarray(meta["win_valid"], bool)
    vo.win_kf_id = np.asarray(meta["win_kf_id"], np.int64)
    vo.num_keyframes = meta["num_keyframes"]
    vo.frame_idx = meta["frame_idx"]
    vo.frames_since_kf = meta["frames_since_kf"]
    vo.initialized = meta["initialized"]
    vo.frontend.threshold = meta.get("frontend_threshold", vo.frontend.threshold)
    vo.trajectory = [
        (np.asarray(R, np.float32), np.asarray(t, np.float32))
        for R, t in meta["trajectory"]
    ]
    # NOTE: restore_vo resumes EXACTLY where saved (bit-identical
    # continuation, tests/test_checkpoint.py).  Crash recovery — where the
    # restored pose is stale by however many frames elapsed after the
    # snapshot — is SnapshotPolicy.restore_latest, which sets
    # ``vo.force_reloc`` so the first post-restore frame relocalizes
    # globally instead of trusting the stale prediction.


# ---------------- DeviceVO (device-resident VOState) ----------------

def save_device_vo(dvo, path) -> None:
    """Checkpoint a DeviceVO: the entire device-resident VOState is one
    pytree -> one .npz; host-side bookkeeping (trajectory,
    stats) goes to meta.json.  Pre-bootstrap instances delegate to the host
    tracker's checkpoint."""
    path = Path(path).resolve()
    dvo.flush()                     # materialize pending chunk summaries
    if dvo.state is None:
        save_vo(dvo._host, path / "host")
        meta = {"format_version": FORMAT_VERSION, "device": False,
                "frame_idx": dvo._frame_idx}
        (path / "device_meta.json").write_text(json.dumps(meta))
        return
    _save_tree(path / "state.npz", _state_dict(dvo.state))
    meta = {
        "format_version": FORMAT_VERSION,
        "device": True,
        "frame_idx": dvo._frame_idx,
        "base": [np.asarray(dvo._base[0]).tolist(),
                 np.asarray(dvo._base[1]).tolist()],
        "lost_streak": dvo._lost_streak,
        "num_reboots": dvo.num_reboots,
        "submap_events": [
            {"frame": e["frame"],
             "base": [np.asarray(e["base"][0]).tolist(),
                      np.asarray(e["base"][1]).tolist()]}
            for e in dvo.submap_events
        ],
        "trajectory": [
            [np.asarray(R).tolist(), np.asarray(t).tolist()]
            for R, t in dvo.trajectory
        ],
        "stats": [
            {"frame": s.frame, "num_features": s.num_features,
             "num_matches": s.num_matches, "num_inliers": s.num_inliers,
             "num_landmarks": s.num_landmarks,
             "is_keyframe": s.is_keyframe, "tracking": s.tracking,
             "rmse_px": s.rmse_px}
            for s in dvo.stats
        ],
    }
    (path / "device_meta.json").write_text(json.dumps(meta))


def _state_dict(state) -> dict:
    """VOState -> plain nested dict (stable leaf keys for the .npz)."""
    return {
        "map": {
            "X": state.map.X, "desc": state.map.desc,
            "valid": state.map.valid, "anchor_kf": state.map.anchor_kf,
            "obs_count": state.map.obs_count, "last_seen": state.map.last_seen,
        },
        "win": {
            "R": state.win_R, "t": state.win_t, "obs": state.win_obs,
            "mask": state.win_mask, "valid": state.win_valid,
            "kf_id": state.win_kf_id,
        },
        "win_feats": _features_dict(state.win_feats),
        "kf_ring": _features_dict(state.kf_ring),
        "pose": {"R": state.R, "t": state.t},
        "vel": {"R": state.vel_R, "t": state.vel_t},
        "scalars": {
            "num_keyframes": state.num_keyframes,
            "frames_since_kf": state.frames_since_kf,
            "frame_idx": state.frame_idx,
            "last_tracking": state.last_tracking,
            "threshold": state.threshold,
        },
    }


def restore_device_vo(dvo, path) -> None:
    """Restore save_device_vo output into a fresh DeviceVO (same config)."""
    import jax.numpy as jnp

    from tinyslam.models.vo import VOStats
    from tinyslam.models.vo_device import VOState
    from tinyslam.types import Features

    path = Path(path).resolve()
    meta = _read_meta(path / "device_meta.json")
    if not meta["device"]:
        restore_vo(dvo._host, path / "host")
        dvo._frame_idx = meta["frame_idx"]
        dvo.trajectory = list(dvo._host.trajectory)
        dvo.stats = list(dvo._host.stats)
        if dvo._host.initialized:
            dvo.state = dvo._lift_state()
        return
    template = VOState.empty(dvo.cfg)
    st = _load_tree(path / "state.npz", _state_dict(template))
    j = jnp.asarray
    dvo.state = VOState(
        map=type(template.map)(
            X=j(st["map"]["X"]), desc=j(st["map"]["desc"]),
            valid=j(st["map"]["valid"]), anchor_kf=j(st["map"]["anchor_kf"]),
            obs_count=j(st["map"]["obs_count"]),
            last_seen=j(st["map"]["last_seen"]),
        ),
        win_R=j(st["win"]["R"]), win_t=j(st["win"]["t"]),
        win_obs=j(st["win"]["obs"]), win_mask=j(st["win"]["mask"]),
        win_valid=j(st["win"]["valid"]), win_kf_id=j(st["win"]["kf_id"]),
        win_feats=Features(
            xy=j(st["win_feats"]["xy"]), level=j(st["win_feats"]["level"]),
            angle=j(st["win_feats"]["angle"]),
            score=j(st["win_feats"]["score"]),
            desc=j(st["win_feats"]["desc"]), valid=j(st["win_feats"]["valid"]),
        ),
        kf_ring=Features(
            xy=j(st["kf_ring"]["xy"]), level=j(st["kf_ring"]["level"]),
            angle=j(st["kf_ring"]["angle"]),
            score=j(st["kf_ring"]["score"]),
            desc=j(st["kf_ring"]["desc"]), valid=j(st["kf_ring"]["valid"]),
        ),
        R=j(st["pose"]["R"]), t=j(st["pose"]["t"]),
        vel_R=j(st["vel"]["R"]), vel_t=j(st["vel"]["t"]),
        num_keyframes=j(st["scalars"]["num_keyframes"]),
        frames_since_kf=j(st["scalars"]["frames_since_kf"]),
        frame_idx=j(st["scalars"]["frame_idx"]),
        last_tracking=j(st["scalars"]["last_tracking"]),
        threshold=j(st["scalars"]["threshold"]),
    )
    dvo._frame_idx = meta["frame_idx"]
    dvo.trajectory = [
        (np.asarray(R, np.float32), np.asarray(t, np.float32))
        for R, t in meta["trajectory"]
    ]
    dvo.stats = [VOStats(**s) for s in meta["stats"]]
    if "base" in meta:
        dvo._base = (np.asarray(meta["base"][0], np.float32),
                     np.asarray(meta["base"][1], np.float32))
    dvo._lost_streak = meta.get("lost_streak", 0)
    dvo.num_reboots = meta.get("num_reboots", 0)
    dvo.submap_events = [
        {"frame": e["frame"],
         "base": (np.asarray(e["base"][0], np.float32),
                  np.asarray(e["base"][1], np.float32))}
        for e in meta.get("submap_events", [])
    ]


# ---------------- Slam (VO + loop-closure state) ----------------

def save_slam(slam, path) -> None:
    """Checkpoint a Slam instance: the inner VO plus the loop-closure layer
    (per-keyframe features/signatures/poses, pose-graph edges)."""
    path = Path(path).resolve()
    save_vo(slam.vo, path / "vo")
    state = {
        "kf_store": [_features_dict(f) for f in slam.kf_store],
        "kf_R": [np.asarray(R) for R in slam.kf_R],
        "kf_t": [np.asarray(t) for t in slam.kf_t],
        "kf_signatures": [np.asarray(s) for s in slam.kf_signatures],
        "kf_lm_X": [np.asarray(a[0]) for a in slam.kf_assoc],
        "kf_lm_ok": [np.asarray(a[1]) for a in slam.kf_assoc],
    }
    if slam.kf_store:
        _save_tree(path / "slam_arrays.npz", state)
    meta = {
        "format_version": FORMAT_VERSION,
        "num_keyframes": len(slam.kf_store),
        "num_loop_closures": slam.num_loop_closures,
        "kf_offset": getattr(slam, "_kf_offset", 0),
        "edges": [
            [int(i), int(j), np.asarray(R).tolist(), np.asarray(t).tolist(),
             float(s), float(w)]
            for i, j, R, t, s, w in slam.edges
        ],
    }
    (path / "slam_meta.json").write_text(json.dumps(meta))


def restore_slam(slam, path) -> None:
    """Restore state saved by save_slam into a freshly-constructed Slam
    (same config)."""
    import jax.numpy as jnp

    from tinyslam.types import Features

    path = Path(path).resolve()
    restore_vo(slam.vo, path / "vo")
    meta = _read_meta(path / "slam_meta.json")
    n = meta["num_keyframes"]
    slam.kf_store, slam.kf_signatures = [], []
    slam.kf_R, slam.kf_t = [], []
    slam.kf_assoc = []
    if n:
        cap = slam.cfg.frontend.max_features
        target = {
            "kf_store": [_features_dict(_empty_features(cap))] * n,
            "kf_R": [np.zeros((3, 3), np.float32)] * n,
            "kf_t": [np.zeros(3, np.float32)] * n,
            "kf_signatures": [np.zeros(256, np.float32)] * n,
            "kf_lm_X": [np.zeros((cap, 3), np.float32)] * n,
            "kf_lm_ok": [np.zeros(cap, bool)] * n,
        }
        state = _load_tree(path / "slam_arrays.npz", target)
        for k in range(n):
            d = state["kf_store"][k]
            slam.kf_store.append(Features(
                xy=jnp.asarray(d["xy"]), level=jnp.asarray(d["level"]),
                angle=jnp.asarray(d["angle"]), score=jnp.asarray(d["score"]),
                desc=jnp.asarray(d["desc"]), valid=jnp.asarray(d["valid"]),
            ))
            slam.kf_R.append(np.asarray(state["kf_R"][k]))
            slam.kf_t.append(np.asarray(state["kf_t"][k]))
            slam.kf_signatures.append(np.asarray(state["kf_signatures"][k]))
            slam.kf_assoc.append((np.asarray(state["kf_lm_X"][k]),
                                  np.asarray(state["kf_lm_ok"][k])))
    if hasattr(slam, "_kf_offset"):
        slam._kf_offset = meta.get("kf_offset", 0)
    slam.num_loop_closures = meta["num_loop_closures"]
    slam.edges = [
        (int(i), int(j), np.asarray(R, np.float32), np.asarray(t, np.float32),
         float(s), float(w))
        for i, j, R, t, s, w in meta["edges"]
    ]
