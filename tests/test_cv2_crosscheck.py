"""Feature-quality cross-validation against OpenCV's ORB (SURVEY §4.1).

The reference has no tests and no quality baseline; the accepted external
oracle for an ORB front-end is cv2.ORB_create.  On a rendered textured-room
pair related by a PURE ROTATION (exact homography ground truth, no depth
ambiguity) we compare, for our detector/descriptor vs OpenCV's, on the
same frames:

  - repeatability: fraction of frame-A detections whose ground-truth
    mapping into frame B lands within 3 px of a frame-B detection;
  - matching score: descriptor matches consistent with the homography
    within 3 px, normalized by detections.

The gate is relative (ours >= ~0.85x cv2 on both metrics): the two
implementations differ legitimately (grid top-k vs Harris-ranked response,
binned vs continuous steering), so parity-not-regression is the honest
assertion.  Runs fully on CPU.
"""

from __future__ import annotations

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from tinyslam.config import FrontendConfig
from tinyslam.data.synthetic import TexturedRoom, default_camera, look_at
from tinyslam.frontend.orb import extract_features
from tinyslam.ops.hamming import match_descriptors

W, H = 640, 480


def _render_rot_pair():
    rng = np.random.default_rng(42)
    room = TexturedRoom(rng, tex_res=64, octaves=2)
    cam = default_camera(W, H)
    C = np.array([0.0, 0.0, -2.0])
    R0, t0 = look_at(C, np.array([0.0, 0.0, 2.0]))
    # ~4 degree yaw, camera centre unchanged -> exact homography.
    ang = np.deg2rad(4.0)
    Rz = np.array([[np.cos(ang), 0, np.sin(ang)],
                   [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]])
    R1 = Rz @ R0
    t1 = -R1 @ C
    imgA = room.render(cam, R0, t0, W, H)
    imgB = room.render(cam, R1, t1, W, H)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    Hab = K @ (R1 @ R0.T) @ np.linalg.inv(K)
    return imgA, imgB, Hab


def _map_pts(Hab, xy):
    p = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ Hab.T
    return p[:, :2] / p[:, 2:3]


def _ours(img):
    cfg = FrontendConfig()
    f = extract_features(jnp.asarray(img.astype(np.float32)),
                         jnp.float32(cfg.threshold), cfg)
    v = np.asarray(f.valid)
    return np.asarray(f.xy)[v], np.asarray(f.desc)[v], v

def _cv2_orb(img):
    orb = cv2.ORB_create(nfeatures=2048)
    g = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    kps, desc = orb.detectAndCompute(g, None)
    xy = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
    return xy, desc


def _repeatability(xyA, xyB, Hab, tol=3.0):
    gt = _map_pts(Hab, xyA)
    inb = ((gt[:, 0] >= 20) & (gt[:, 0] < W - 20)
           & (gt[:, 1] >= 20) & (gt[:, 1] < H - 20))
    if inb.sum() == 0:
        return 0.0
    d = np.linalg.norm(gt[inb][:, None, :] - xyB[None, :, :], axis=-1)
    return float((d.min(axis=1) <= tol).mean())


def _match_score_ours(xyA, dA, xyB, dB, Hab, tol=3.0):
    va = jnp.ones(len(dA), bool)
    vb = jnp.ones(len(dB), bool)
    m = match_descriptors(jnp.asarray(dA), va, jnp.asarray(dB), vb)
    ok = np.asarray(m["valid"])
    idx = np.asarray(m["idx_b"])
    gt = _map_pts(Hab, xyA)
    err = np.linalg.norm(gt - xyB[idx], axis=-1)
    good = ok & (err <= tol)
    return float(good.sum()) / max(min(len(xyA), len(xyB)), 1)


def _match_score_cv2(xyA, dA, xyB, dB, Hab, tol=3.0):
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    matches = bf.match(dA, dB)
    gt = _map_pts(Hab, xyA)
    good = sum(
        1 for m in matches
        if np.linalg.norm(gt[m.queryIdx] - xyB[m.trainIdx]) <= tol)
    return good / max(min(len(xyA), len(xyB)), 1)


def test_not_worse_than_cv2_orb():
    imgA, imgB, Hab = _render_rot_pair()
    xyA, dA, _ = _ours(imgA)
    xyB, dB, _ = _ours(imgB)
    cA, cdA = _cv2_orb(imgA)
    cB, cdB = _cv2_orb(imgB)
    assert len(xyA) > 500 and len(cA) > 500

    rep_ours = _repeatability(xyA, xyB, Hab)
    rep_cv2 = _repeatability(cA, cB, Hab)
    ms_ours = _match_score_ours(xyA, dA, xyB, dB, Hab)
    ms_cv2 = _match_score_cv2(cA, cdA, cB, cdB, Hab)
    print(f"repeatability ours={rep_ours:.3f} cv2={rep_cv2:.3f} | "
          f"match score ours={ms_ours:.3f} cv2={ms_cv2:.3f}")

    assert rep_ours >= 0.85 * rep_cv2, (rep_ours, rep_cv2)
    assert ms_ours >= 0.85 * ms_cv2, (ms_ours, ms_cv2)
    # Absolute floors so the relative gate can't pass vacuously.
    assert rep_ours > 0.5
    assert ms_ours > 0.25
