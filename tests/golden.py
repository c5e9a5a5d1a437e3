"""Pure-numpy golden reimplementations for kernel unit tests (SURVEY §4.1).

Deliberately written as naive loops / direct formulas — slow and obviously
correct — so the vectorized JAX/Pallas kernels have an independent oracle.
Use small images.
"""

from __future__ import annotations

import numpy as np

from tinyslam.ops.brief import BRIEF_PATTERN
from tinyslam.ops.fast import RING16


def streak16_naive(x: int, n: int = 12) -> bool:
    """True iff the 16-bit mask has a circular run of >= n set bits."""
    bits = [(x >> i) & 1 for i in range(16)]
    for start in range(16):
        if all(bits[(start + j) % 16] for j in range(n)):
            return True
    return False


def patch_moments_naive(img: np.ndarray, radius: int = 7):
    """Golden separable patch moments, mirroring ops.fast.patch_moments'
    two-stage edge padding exactly (pad, box-sum one axis; pad the result,
    ramp the other)."""
    h, w = img.shape
    r = radius
    p = np.pad(img, r, mode="edge")
    box_y = np.zeros((h, w), np.float64)
    box_x = np.zeros((h, w), np.float64)
    for i in range(2 * r + 1):
        box_y += p[i : i + h, r : r + w]
        box_x += p[r : r + h, i : i + w]
    py = np.pad(box_y, ((0, 0), (r, r)), mode="edge")
    px = np.pad(box_x, ((r, r), (0, 0)), mode="edge")
    m10 = np.zeros((h, w), np.float64)
    m01 = np.zeros((h, w), np.float64)
    for i in range(2 * r + 1):
        m10 += (i - r) * py[:, i : i + w]
        m01 += (i - r) * px[i : i + h, :]
    return m10.astype(np.float32), m01.astype(np.float32)


def fast_score_naive(img: np.ndarray, t: float, border: int, streak: int = 9):
    """Golden FAST-16: returns (score, m10, m01) maps.

    Matches ops.fast.fast_score_map semantics: edge-padded ring reads,
    margin score = max(sum(d - t | d > t side), sum(-d - t | dark side))
    gated on a >=streak circular run, zero outside the border; orientation
    moments over the 15x15 patch.
    """
    h, w = img.shape
    p = np.pad(img, 3, mode="edge")
    score = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            if not (border <= y < h - border and border <= x < w - border):
                continue
            ring = np.array(
                [p[3 + y + dy, 3 + x + dx] for dx, dy in RING16], np.float32
            )
            d = ring - img[y, x]
            over = int(sum((1 << i) for i in range(16) if d[i] > t))
            under = int(sum((1 << i) for i in range(16) if d[i] < -t))
            if streak16_naive(over, streak) or streak16_naive(under, streak):
                so = float(np.sum(np.maximum(d - t, 0.0)))
                su = float(np.sum(np.maximum(-d - t, 0.0)))
                score[y, x] = max(so, su)
    m10, m01 = patch_moments_naive(img)
    return score, m10, m01


def nms3x3_naive(score: np.ndarray) -> np.ndarray:
    """Keep a positive pixel iff it strictly beats raster-earlier neighbours
    and ties-or-beats raster-later ones (matches ops.fast.nms3x3)."""
    h, w = score.shape
    p = np.full((h + 2, w + 2), -np.inf, np.float32)
    p[1:-1, 1:-1] = score
    out = np.zeros_like(score)
    for y in range(h):
        for x in range(w):
            s = score[y, x]
            if s <= 0:
                continue
            keep = True
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == 0 and dx == 0:
                        continue
                    nb = p[1 + y + dy, 1 + x + dx]
                    if (dy, dx) < (0, 0):
                        keep &= s > nb
                    else:
                        keep &= s >= nb
            if keep:
                out[y, x] = s
    return out


def brief_naive(blurred: np.ndarray, xy: np.ndarray, angle: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
    """Golden steered BRIEF: (N, 8) uint32, nearest (rint) sampling."""
    h, w = blurred.shape
    n = xy.shape[0]
    out = np.zeros((n, 8), np.uint32)
    for i in range(n):
        if not valid[i]:
            continue
        c, s = np.cos(angle[i]), np.sin(angle[i])
        for k in range(256):
            (ax, ay), (bx, by) = BRIEF_PATTERN[k]
            rax = int(np.clip(np.rint(c * ax - s * ay + xy[i, 0]), 0, w - 1))
            ray = int(np.clip(np.rint(s * ax + c * ay + xy[i, 1]), 0, h - 1))
            rbx = int(np.clip(np.rint(c * bx - s * by + xy[i, 0]), 0, w - 1))
            rby = int(np.clip(np.rint(s * bx + c * by + xy[i, 1]), 0, h - 1))
            if blurred[ray, rax] > blurred[rby, rbx]:
                out[i, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    return out


def brief_binned_naive(blurred: np.ndarray, xy: np.ndarray, angle: np.ndarray,
                       valid: np.ndarray, bins: int = 32) -> np.ndarray:
    """Golden quantized-orientation BRIEF: pattern pre-rotated by the bin
    center, offsets rounded independently of the rounded feature center
    (the semantics of ops.brief.brief_descriptors_binned)."""
    n = xy.shape[0]
    out = np.zeros((n, 8), np.uint32)
    for i in range(n):
        if not valid[i]:
            continue
        b = int(np.rint(angle[i] / (2 * np.pi / bins))) % bins
        th = 2 * np.pi * b / bins
        c, s = np.cos(th), np.sin(th)
        cx = int(np.rint(xy[i, 0]))
        cy = int(np.rint(xy[i, 1]))
        for k in range(256):
            (ax, ay), (bx, by) = BRIEF_PATTERN[k].astype(np.float64)
            va = blurred[cy + int(np.rint(s * ax + c * ay)),
                         cx + int(np.rint(c * ax - s * ay))]
            vb = blurred[cy + int(np.rint(s * bx + c * by)),
                         cx + int(np.rint(c * bx - s * by))]
            if np.float32(va) - np.float32(vb) > 0:
                out[i, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    return out


def hamming_naive(da: np.ndarray, db: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) packed uint32 -> (N, M) popcount(xor) distances."""
    n, m = da.shape[0], db.shape[0]
    out = np.zeros((n, m), np.int32)
    for i in range(n):
        for j in range(m):
            out[i, j] = sum(
                bin(int(da[i, k]) ^ int(db[j, k])).count("1") for k in range(8)
            )
    return out


def checkerboard(h: int, w: int, cell: int = 8) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // cell) + (xs // cell)) % 2).astype(np.float32)


def dot_grid(h: int, w: int, spacing: int = 12, dot: int = 3,
             offset: int = 6) -> np.ndarray:
    """Bright dot x dot squares centered on a `spacing` grid — every dot is an
    unambiguous FAST corner (its radius-3 ring is entirely dark), unlike
    checkerboard X-junctions, which FAST famously does not detect (the ring
    alternates bright/dark in ~4-point arcs, never a long run)."""
    img = np.full((h, w), 0.2, np.float32)
    r = dot // 2
    for cy in range(offset, h - offset, spacing):
        for cx in range(offset, w - offset, spacing):
            img[cy - r : cy + r + 1, cx - r : cx + r + 1] = 0.9
    return img


def corner_image(h: int = 64, w: int = 64, cx: int = 32, cy: int = 32) -> np.ndarray:
    """A single bright square corner at (cx, cy) on dark background."""
    img = np.full((h, w), 0.2, np.float32)
    img[cy:, cx:] = 0.9
    return img
