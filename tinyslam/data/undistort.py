"""Radial-tangential (plumb-bob) lens undistortion.

The device-side camera model is a linear pinhole (geometry/camera.py) — the
right design for a fixed-shape pipeline, since distortion correction is a
per-pixel remap that matmuls gain nothing from and XLA shape machinery only
suffers under.  Instead the
loaders undistort at ingest: a remap table is precomputed ONCE per camera
(`Undistorter`), then each frame is one vectorized bilinear gather.

Model (OpenCV / Kalibr radtan, normalized coords x = (u-cx)/fx):

    r^2  = x^2 + y^2
    x_d  = x (1 + k1 r^2 + k2 r^4 + k3 r^6) + 2 p1 x y + p2 (r^2 + 2 x^2)
    y_d  = y (1 + k1 r^2 + k2 r^4 + k3 r^6) + p1 (r^2 + 2 y^2) + 2 p2 x y

The remap is target->source: for every *undistorted* output pixel we distort
its normalized coords and sample the raw image there — no iterative inverse
needed.  Verified against OpenCV's initUndistortRectifyMap in
tests/test_undistort.py.

The reference has no camera model at all (its roadmap stops at feature
extraction, reference README.md:53-57); EuRoC/TUM calibrations make this
mandatory for the accuracy targets (EuRoC cam0 k1 = -0.283).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def radtan_distort(
    x: np.ndarray,
    y: np.ndarray,
    k1: float = 0.0,
    k2: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    k3: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Apply the radtan model to normalized image coords (forward map)."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def radtan_undistort_points(
    xd: np.ndarray,
    yd: np.ndarray,
    k1: float = 0.0,
    k2: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    k3: float = 0.0,
    iters: int = 10,
) -> tuple[np.ndarray, np.ndarray]:
    """Invert the radtan model (distorted -> ideal normalized coords) by
    fixed-point iteration — the same scheme as OpenCV's undistortPoints."""
    x, y = np.array(xd, np.float64), np.array(yd, np.float64)
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        # Outside the valid image circle the fixed point diverges (strong
        # negative k1 drives `radial` through zero); unclamped, the
        # runaway inf/denormal arithmetic is ~1000x slower than the math
        # itself (measured: 269 s for one 752x480 grid).  Normalized
        # coords beyond |4| are far outside any real FOV — clamp.
        radial = np.clip(radial, 0.1, 10.0)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = np.clip((xd - dx) / radial, -4.0, 4.0)
        y = np.clip((yd - dy) / radial, -4.0, 4.0)
    return x, y


def undistort_maps(
    intrinsics: dict, dist: dict, height: int, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Source-pixel sampling maps (map_x, map_y), each (H, W) float32.

    Output pixel (u, v) of the undistorted image (same intrinsics K) samples
    the raw image at (map_x[v,u], map_y[v,u]).  Equivalent to OpenCV's
    initUndistortRectifyMap(K, D, None, K, (W, H), CV_32F).
    """
    fx, fy = intrinsics["fx"], intrinsics["fy"]
    cx, cy = intrinsics["cx"], intrinsics["cy"]
    u, v = np.meshgrid(
        np.arange(width, dtype=np.float64),
        np.arange(height, dtype=np.float64),
    )
    x = (u - cx) / fx
    y = (v - cy) / fy
    xd, yd = radtan_distort(
        x, y,
        k1=dist.get("k1", 0.0), k2=dist.get("k2", 0.0),
        p1=dist.get("p1", 0.0), p2=dist.get("p2", 0.0),
        k3=dist.get("k3", 0.0),
    )
    return (
        (xd * fx + cx).astype(np.float32),
        (yd * fy + cy).astype(np.float32),
    )


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Bilinear gather of `img` at (map_x, map_y); out-of-range clamps to the
    border pixel (matches a clamp-to-edge sampler).  Preserves uint8 dtype.

    Accepts (H, W) or (H, W, C).
    """
    h, w = img.shape[:2]
    x = np.clip(map_x, 0.0, w - 1.0)
    y = np.clip(map_y, 0.0, h - 1.0)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (x - x0).astype(np.float32)
    wy = (y - y0).astype(np.float32)
    if img.ndim == 3:
        wx = wx[..., None]
        wy = wy[..., None]
    f = img.astype(np.float32)
    out = (
        f[y0, x0] * (1 - wx) * (1 - wy)
        + f[y0, x1] * wx * (1 - wy)
        + f[y1, x0] * (1 - wx) * wy
        + f[y1, x1] * wx * wy
    )
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


@dataclass
class Undistorter:
    """Precomputed per-camera undistortion remap.

    ``Undistorter(intrinsics, dist, h, w)(frame)`` returns the undistorted
    frame under the SAME intrinsics — downstream geometry keeps using the
    calibrated (fx, fy, cx, cy) as a pure pinhole.
    """

    intrinsics: dict
    dist: dict
    height: int
    width: int

    def __post_init__(self):
        self.map_x, self.map_y = undistort_maps(
            self.intrinsics, self.dist, self.height, self.width
        )
        self.identity = all(
            abs(self.dist.get(k, 0.0)) < 1e-12
            for k in ("k1", "k2", "p1", "p2", "k3")
        )

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.identity:
            return img
        return remap_bilinear(np.asarray(img), self.map_x, self.map_y)
