"""Oriented FAST-16 corner scoring as a dense, branch-free map.

A dense re-design of the reference's FAST compute shader
(reference src/shaders/fast.wgsl:64-158).  What carries over is the *bitwise
streak trick* (fast.wgsl:51-60): pack the 16 ring comparisons into an int32
bitmask and find a contiguous run of >=12 set bits with 4 rotate-AND steps —
which vectorizes as elementwise int32 ops.  What does NOT carry over is the
per-pixel-thread shape: the 4-corner early-out branch (fast.wgsl:85-95 — a
dense map always runs the full test, so XLA can fuse it), and the two-level
atomic compaction (fast.wgsl:122-147 — replaced by a deterministic score
map + top-k in ops.compact, eliminating the race surface entirely, SURVEY
§5).

Outputs are dense maps: corner score, and the intensity-centroid moments
(m10, m01) from which ops.compact computes `atan2` orientation only at the
selected features (the reference computes atan2 per candidate pixel,
fast.wgsl:115; dense transcendentals would be wasted work).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# The 16-point Bresenham circle of radius 3, in circular order starting from
# (dx, dy) = (0, -3) going clockwise (same circle as reference fast.wgsl:32-49;
# circular order is all the streak test requires).
RING16: tuple[tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

_MASK16 = jnp.int32(0xFFFF)


def _rot16(x: jax.Array, c: int) -> jax.Array:
    """Rotate the low 16 bits of an int32 right by c (bit i <- bit (i+c)%16)."""
    return ((x >> c) | (x << (16 - c))) & _MASK16


def detect_streak(x: jax.Array, n: int) -> jax.Array:
    """Nonzero iff the 16-bit mask has a circular run of >= n set bits.

    Bit i of the result is set iff bits i..i+n-1 (mod 16) are all set.
    Generalizes the reference's 4-step rotate-AND trick (fast.wgsl:51-60,
    hard-coded n=12) to any run length via the doubling identity
    run_{a+b}(x) = run_a(x) & rot(run_b(x), a) — O(log n) branch-free int32
    elementwise ops.

    Note n=12 (the reference's choice) cannot detect a perfect 90-degree
    corner: only 11 of the 16 ring points fall outside a right-angle wedge.
    Canonical ORB / ORB-SLAM use FAST-9; FrontendConfig.streak_length
    defaults to 9 for that reason.
    """
    assert 1 <= n <= 16
    x = x & _MASK16
    # Powers-of-two runs by doubling: run_{2k}(x) = run_k(x) & rot(run_k, k).
    pow_runs = {1: x}
    k = 1
    while k * 2 <= n:
        pow_runs[k * 2] = pow_runs[k] & _rot16(pow_runs[k], k)
        k *= 2
    # Compose n from its binary decomposition:
    # run_{a+b}(x) = run_a(x) & rot(run_b(x), a).
    run = None
    length = 0
    for p in sorted(pow_runs, reverse=True):
        if length + p <= n:
            run = pow_runs[p] if run is None else run & _rot16(pow_runs[p], length)
            length += p
    assert length == n
    return run


def detect_streak_16(x: jax.Array) -> jax.Array:
    """The reference's exact n=12 variant (fast.wgsl:51-60)."""
    return detect_streak(x, 12)


def _ring_stack(img: jax.Array) -> jax.Array:
    """(H, W) -> (16, H, W): ring neighbourhood via 16 static slices of an
    edge-padded copy.  Static slices (no gather) keep this one fused pass."""
    h, w = img.shape[-2:]
    p = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(3, 3), (3, 3)], mode="edge")
    return jnp.stack(
        [p[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in RING16],
        axis=0,
    )


def fast_score_map(
    img: jax.Array,
    threshold: float | jax.Array,
    border: int = 20,
    streak: int = 9,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Dense FAST-16 corner response.

    Args:
      img: (H, W) float32 grayscale in [0, 1] (one pyramid level).
      threshold: FAST intensity threshold (reference uniform, fast.wgsl:17).
      border: pixels near the edge to zero out so BRIEF can sample its rotated
        +/-13 pattern (reference uses 16, fast.wgsl:74-77 — too small, §2a).
      streak: required circular run length on the 16-ring (9 = canonical ORB;
        12 = the reference's semantics, see detect_streak).

    Returns:
      score: (H, W) float32, 0 for non-corners.  For corners: the larger of
        sum(d - t) over brighter ring points / sum(-d - t) over darker ones —
        the OpenCV-style margin score used to rank detections for top-k.
      m10, m01: (H, W) float32 intensity-centroid moments over the ring
        (reference fast.wgsl:100-115 accumulates the same 16 points).
    """
    img = img.astype(jnp.float32)
    t = jnp.asarray(threshold, jnp.float32)
    ring = _ring_stack(img)                       # (16, H, W)
    d = ring - img[None]

    bit = jnp.int32(1) << jnp.arange(16, dtype=jnp.int32)  # (16,)
    over = (d > t).astype(jnp.int32)
    under = (d < -t).astype(jnp.int32)
    bits_over = jnp.tensordot(bit, over, axes=((0,), (0,)))
    bits_under = jnp.tensordot(bit, under, axes=((0,), (0,)))

    is_corner = (detect_streak(bits_over, streak) | detect_streak(bits_under, streak)) > 0

    margin_over = jnp.sum(jnp.maximum(d - t, 0.0), axis=0)
    margin_under = jnp.sum(jnp.maximum(-d - t, 0.0), axis=0)
    score = jnp.where(is_corner, jnp.maximum(margin_over, margin_under), 0.0)

    # Border guard (reference fast.wgsl:74-77, widened to the true BRIEF reach).
    h, w = img.shape[-2:]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = jnp.where(inside, score, 0.0)

    with jax.named_scope("moments"):
        m10, m01 = patch_moments(img)
    return score, m10, m01


def patch_moments(img: jax.Array, radius: int = 7) -> tuple[jax.Array, jax.Array]:
    """Dense intensity-centroid moments over a (2r+1)^2 patch, separably.

    The reference accumulates the centroid over the 16 ring pixels only
    (fast.wgsl:100-115) — on high-frequency texture that orientation is
    nearly random, so the steered BRIEF rotation jitters between frames and
    descriptors stop matching.  Canonical ORB uses a large-patch centroid;
    here it is two separable passes per moment (box-sum one axis, linear
    ramp the other), fused by XLA into loop fusions.

    m10(x, y) = sum_{|dx|,|dy| <= r} dx * I(x+dx, y+dy);  m01 likewise with dy.
    """
    h, w = img.shape[-2:]
    pad = [(0, 0)] * (img.ndim - 2) + [(radius, radius), (radius, radius)]
    p = jnp.pad(img, pad, mode="edge")

    def sweep(arr, axis, ramp):
        out = None
        n = img.shape[axis]
        for i in range(2 * radius + 1):
            coef = float(i - radius) if ramp else 1.0
            if coef == 0.0:
                continue
            sl = jax.lax.slice_in_dim(arr, i, i + n, axis=axis)
            term = sl * coef if ramp else sl
            out = term if out is None else out + term
        return out

    box_y = sweep(jax.lax.slice_in_dim(p, radius, radius + w, axis=img.ndim - 1),
                  img.ndim - 2, ramp=False)
    box_x = sweep(jax.lax.slice_in_dim(p, radius, radius + h, axis=img.ndim - 2),
                  img.ndim - 1, ramp=False)
    # m10: ramp along x of the y-box-sum; m01: ramp along y of the x-box-sum.
    py = jnp.pad(box_y, [(0, 0)] * (img.ndim - 2) + [(0, 0), (radius, radius)],
                 mode="edge")
    px = jnp.pad(box_x, [(0, 0)] * (img.ndim - 2) + [(radius, radius), (0, 0)],
                 mode="edge")
    m10 = sweep(py, img.ndim - 1, ramp=True)
    m01 = sweep(px, img.ndim - 2, ramp=True)
    return m10, m01


def nms3x3(score: jax.Array) -> jax.Array:
    """3x3 non-max suppression: keep a pixel iff it is the maximum of its
    3x3 neighbourhood (strictly greater than the raster-later neighbours so
    plateau ties keep exactly one pixel).  The reference has no NMS at all
    (nothing in fast.wgsl suppresses adjacent detections) — this is a free
    quality improvement noted in SURVEY §7."""
    h, w = score.shape[-2:]
    p = jnp.pad(score, [(0, 0)] * (score.ndim - 2) + [(1, 1), (1, 1)],
                mode="constant", constant_values=-jnp.inf)

    def shifted(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    keep = score > 0
    # Strict > for neighbours earlier in raster order, >= for later ones.
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = shifted(dy, dx)
            if (dy, dx) < (0, 0) or (dy == 0 and dx < 0):
                keep &= score > nb
            else:
                keep &= score >= nb
    return jnp.where(keep, score, 0.0)
