"""Radtan undistortion vs the OpenCV oracle (SURVEY §4.1: independent
golden references, not self-reimplementations)."""

import numpy as np
import pytest

from tinyslam.data.undistort import (
    Undistorter,
    radtan_distort,
    remap_bilinear,
    undistort_maps,
)

cv2 = pytest.importorskip("cv2")

EUROC = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375)
EUROC_D = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
TUM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3)
TUM_D = dict(k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633)


def _K(i):
    return np.array([[i["fx"], 0, i["cx"]], [0, i["fy"], i["cy"]], [0, 0, 1]])


def _D(d):
    return np.array([d.get("k1", 0), d.get("k2", 0), d.get("p1", 0),
                     d.get("p2", 0), d.get("k3", 0)])


@pytest.mark.parametrize("intr,dist,h,w", [
    (EUROC, EUROC_D, 480, 752),
    (TUM, TUM_D, 480, 640),
])
def test_maps_match_opencv(intr, dist, h, w):
    mx, my = undistort_maps(intr, dist, h, w)
    cx, cy = cv2.initUndistortRectifyMap(
        _K(intr), _D(dist), None, _K(intr), (w, h), cv2.CV_32FC1)
    np.testing.assert_allclose(mx, cx, atol=2e-2)
    np.testing.assert_allclose(my, cy, atol=2e-2)


def test_distort_matches_opencv_projectpoints():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.6, 0.6, 200)
    y = rng.uniform(-0.5, 0.5, 200)
    xd, yd = radtan_distort(x, y, **EUROC_D)
    pts = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 1, 3)
    proj, _ = cv2.projectPoints(pts, np.zeros(3), np.zeros(3),
                                np.eye(3), _D(EUROC_D))
    np.testing.assert_allclose(
        np.stack([xd, yd], -1), proj.reshape(-1, 2), atol=1e-9)


def test_remap_matches_opencv_bilinear():
    rng = np.random.default_rng(4)
    img = (rng.random((480, 752)) * 255).astype(np.uint8)
    und = Undistorter(EUROC, EUROC_D, 480, 752)
    ours = und(img)
    theirs = cv2.remap(img, und.map_x, und.map_y, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REPLICATE)
    # Interior must agree except for rounding-at-.5 ties; compare away from
    # the heavily-stretched border band.
    a = ours[40:-40, 60:-60].astype(np.int32)
    b = theirs[40:-40, 60:-60].astype(np.int32)
    assert np.mean(np.abs(a - b) <= 1) > 0.999


def test_undistort_straightens_lines():
    # Render a distorted image of vertical lines via the forward model, then
    # undistort: the lines must come back straight (variance of per-row edge
    # x-positions collapses).
    h, w = 480, 752
    und = Undistorter(EUROC, EUROC_D, h, w)
    # Distorted image = sample of an ideal line image at distorted coords:
    # build ideal image, then for each distorted-image pixel, sample ideal at
    # its UNdistorted position -> requires inverse; instead reuse our own
    # remap with roles swapped: distorted(u) = ideal(maps(u)) is exactly what
    # und() inverts, so und(distorted) ~= ideal away from the border.
    ideal = np.zeros((h, w), np.float32)
    ideal[:, 100::75] = 1.0
    # forward-distort ideal with the inverse mapping trick:
    distorted = remap_bilinear(ideal, *_inverse_maps(und))
    restored = und(distorted)
    err = np.abs(restored[60:-60, 60:-60] - ideal[60:-60, 60:-60])
    assert float(np.mean(err)) < 0.02


def _inverse_maps(und):
    """Numerically invert the undistort maps with OpenCV's iterative
    undistortPoints (oracle), giving forward-distortion sampling maps."""
    h, w = und.height, und.width
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    pts = np.stack([u.ravel(), v.ravel()], -1).reshape(-1, 1, 2)
    out = cv2.undistortPoints(pts, _K(und.intrinsics), _D(und.dist),
                              P=_K(und.intrinsics))
    out = out.reshape(h, w, 2)
    return out[..., 0].astype(np.float32), out[..., 1].astype(np.float32)


def test_identity_when_no_distortion():
    und = Undistorter(EUROC, {}, 480, 752)
    img = np.arange(480 * 752, dtype=np.uint8).reshape(480, 752)
    assert und(img) is img
