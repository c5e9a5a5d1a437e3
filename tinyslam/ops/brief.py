"""Steered (rotated) BRIEF-256 descriptors.

A device re-design of the reference's BRIEF compute shader (reference
src/shaders/brief.wgsl:22-68): per feature, 256 intensity comparisons between
rotated point pairs sampled from the *blurred* pyramid level the feature was
detected at, packed into 8 x u32 (brief.wgsl:43-67).  The reference spreads
one feature over 8 threads, one 32-bit word each; here the whole (N_features
x 256 pairs) grid is one vectorized compare — rotation, rounding and the
pack are fused elementwise arithmetic, and the only memory-irregular step is two
(N, 256) gathers from the level image.

The sampling pattern: the reference embeds the classic learned ORB
``bit_pattern_31`` table (brief.wgsl:70-327).  We use deterministic Gaussian
pairs (the original BRIEF recipe: coords ~ N(0, (patch/5)^2) clipped to the
+/-13 box) — a choice that is now A/B-JUSTIFIED rather than assumed: a
decorrelated pattern trained with the ORB-paper greedy procedure on our own
rendered corner patches (tools/train_brief_pattern.py; shipped as
brief_pattern_learned.LEARNED_PATTERN) does achieve lower bit correlation
(mean |corr| 0.067 vs 0.115) but MATCHES WORSE on the rendered rotation-pair
benchmark (469 matches @ mean Hamming 37.1 vs 537 @ 31.8,
tests/test_brief_pattern.py): greedy mean-near-0.5 selection favours
boundary-straddling intensity tests whose bits flip under pixel noise, and
per-bit stability beats decorrelation for ratio-test matching here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 13  # +/-13 box, as the reference's table (brief.wgsl coords)

# Matmul precision for the binned-BRIEF products (the front end's dominant
# FLOPs).  DEFAULT lets XLA run these f32 products in TF32 on the GPU: a
# TF32-rounded pixel carries ~0.05% relative error, so a few descriptor bits
# can differ from HIGHEST (exact one-hot copies).  chip_smoke.py bounds that
# disagreement on the card; TINYSLAM_BRIEF_PRECISION=highest selects HIGHEST.
import os as _os

_MM_PRECISION = {
    "default": jax.lax.Precision.DEFAULT,
    "float32": jax.lax.Precision.HIGHEST,
    "highest": jax.lax.Precision.HIGHEST,
}[_os.environ.get("TINYSLAM_BRIEF_PRECISION", "default")]


def _make_pattern(num_pairs: int = 256, seed: int = 7) -> np.ndarray:
    """(num_pairs, 2, 2) int32: [pair, point a/b, (x, y)]; deterministic."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(num_pairs, 2, 2))
    pts = np.clip(np.rint(pts), -PATCH_RADIUS, PATCH_RADIUS).astype(np.int32)
    # Avoid degenerate pairs (a == b -> constant-zero bit).
    for i in range(num_pairs):
        while (pts[i, 0] == pts[i, 1]).all():
            pts[i, 1] = np.clip(
                np.rint(rng.normal(0.0, sigma, size=2)), -PATCH_RADIUS, PATCH_RADIUS
            ).astype(np.int32)
    return pts


RANDOM_PATTERN: np.ndarray = _make_pattern()
BRIEF_PATTERN: np.ndarray = RANDOM_PATTERN  # the A/B winner (see docstring)

# Rotated-pattern reach: |R(theta) p|_inf <= |p|_2 <= 13*sqrt(2) < 19.
PATCH_REACH = 19
PATCH_SIDE = 2 * PATCH_REACH + 2   # 40: even side keeps matmul shapes aligned


@functools.lru_cache(maxsize=4)
def _binned_tables(bins: int) -> np.ndarray:
    """(PATCH_SIDE^2, bins*256) float32 difference-selection matrix.

    Column (a*256 + j) holds +1 at the flattened in-patch offset of pattern
    point ``j.a`` rotated by bin angle ``2*pi*a/bins`` and -1 at point
    ``j.b``'s offset, so ``patch_flat @ D`` yields every bin's 256 intensity
    differences in one matmul.  (+1)+(-1) can land on the same cell for
    near-degenerate rotated pairs; the sum (0 -> bit=0) is the right
    semantics.
    """
    pat = BRIEF_PATTERN.astype(np.float64)               # (256, 2, 2)
    ps = PATCH_SIDE
    D = np.zeros((ps * ps, bins * 256), np.float32)
    for a in range(bins):
        th = 2.0 * np.pi * a / bins
        c, s = np.cos(th), np.sin(th)
        for j in range(256):
            for k, sign in ((0, 1.0), (1, -1.0)):
                px, py = pat[j, k]
                ox = int(np.rint(c * px - s * py))
                oy = int(np.rint(s * px + c * py))
                D[(oy + PATCH_REACH) * ps + (ox + PATCH_REACH),
                  a * 256 + j] += sign
    return D


@functools.partial(jax.jit, static_argnames=("bins", "precision"))
def brief_descriptors_binned(
    blurred: jax.Array,
    xy: jax.Array,
    angle: jax.Array,
    valid: jax.Array,
    bins: int = 32,
    precision: jax.lax.Precision = _MM_PRECISION,
) -> jax.Array:
    """Steered BRIEF-256 with quantized orientation, as matrix products.

    The continuous-angle path (brief_descriptors) needs 512 data-dependent
    image gathers per feature — the one memory-irregular op in the front
    end (SURVEY §7 hard part 3).  This path removes per-bit gathers
    entirely:

      1. orientation is quantized to ``bins`` (ORB itself uses 12-degree
         bins for its rotated pattern; 32 bins is finer);
      2. a 40x40 patch around each feature is extracted with a row gather
         (major-axis, large contiguous slices) plus a one-hot column-select
         einsum — no scalar gathers;
      3. all ``bins * 256`` rotated pair differences per feature come from
         ONE (N, 1600) x (1600, bins*256) f32 matmul against a constant
         +-1 table (exact: each output is va - vb in f32), and the
         feature's bin is selected with a one-hot contraction.

    Equivalent to brief_descriptors with the pattern pre-rotated by the
    bin center and offsets rounded before (not after) adding the rounded
    feature position.  Requires features >= PATCH_REACH+1 px from the
    border (FrontendConfig.border = 20 guarantees it); invalid slots are
    zeroed, out-of-range xy values clamp harmlessly into range.

    Returns: (N, 8) uint32 packed descriptors.
    """
    h, w = blurred.shape
    n = xy.shape[0]
    ps = PATCH_SIDE
    D = jnp.asarray(_binned_tables(bins))                # (ps*ps, bins*256)

    center = jnp.rint(xy).astype(jnp.int32)              # (N, 2)
    base = center - PATCH_REACH                          # patch top-left
    bx = jnp.clip(base[:, 0], 0, w - ps)
    by = jnp.clip(base[:, 1], 0, h - ps)

    # Row gather: (N*ps, w) large contiguous slices along the major axis.
    rows = blurred[(by[:, None] + jnp.arange(ps)[None, :]).reshape(-1)]
    rows = rows.reshape(n, ps, w)
    # Column select as a one-hot einsum — f32, so each patch value is exact
    # (a one-hot dot is a copy) at HIGHEST precision.
    col_onehot = jax.nn.one_hot(
        bx[:, None] + jnp.arange(ps)[None, :], w, dtype=jnp.float32)
    patches = jnp.einsum(
        "nrw,ncw->nrc", rows, col_onehot,
        preferred_element_type=jnp.float32,
        precision=precision)                         # (N, ps, ps)

    diff = jax.lax.dot_general(
        patches.reshape(n, ps * ps), D,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision)                         # (N, bins*256)
    bits_all = (diff > 0).reshape(n, bins, 256)

    two_pi = 2.0 * np.pi
    bin_idx = jnp.round(angle / (two_pi / bins)).astype(jnp.int32) % bins
    bin_onehot = jax.nn.one_hot(bin_idx, bins, dtype=jnp.float32)  # (N, bins)
    bits = jnp.einsum(
        "nab,na->nb", bits_all.astype(jnp.float32), bin_onehot) > 0.5

    words = bits.reshape(-1, 8, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)
    return jnp.where(valid[:, None], desc, jnp.uint32(0))


@functools.partial(jax.jit, static_argnames=("interpolate",))
def brief_descriptors(
    blurred: jax.Array,
    xy: jax.Array,
    angle: jax.Array,
    valid: jax.Array,
    interpolate: bool = False,
) -> jax.Array:
    """Compute steered BRIEF-256 for features on ONE pyramid level.

    Args:
      blurred: (H, W) float32 — the blurred level (reference blur_hierarchy).
      xy: (N, 2) float32 — feature (x, y) in THIS level's pixel coords.
      angle: (N,) float32 — orientation in radians.
      valid: (N,) bool.
      interpolate: bilinear sampling instead of nearest (reference uses
        integer truncation, brief.wgsl:57-58; nearest-rint is the default).

    Returns: (N, 8) uint32 packed descriptors (invalid slots are zero).
    """
    h, w = blurred.shape
    flat = blurred.reshape(-1)

    pat = jnp.asarray(BRIEF_PATTERN, jnp.float32)        # (256, 2, 2)
    pax, pay = pat[:, 0, 0], pat[:, 0, 1]                # (256,)
    pbx, pby = pat[:, 1, 0], pat[:, 1, 1]

    c = jnp.cos(angle)[:, None]                          # (N, 1)
    s = jnp.sin(angle)[:, None]
    x0 = xy[:, 0:1]
    y0 = xy[:, 1:2]

    def rotated(px, py):
        rx = c * px[None, :] - s * py[None, :] + x0      # (N, 256)
        ry = s * px[None, :] + c * py[None, :] + y0
        return rx, ry

    def sample(rx, ry):
        if interpolate:
            fx = jnp.clip(rx, 0.0, w - 1.001)
            fy = jnp.clip(ry, 0.0, h - 1.001)
            x1 = jnp.floor(fx).astype(jnp.int32)
            y1 = jnp.floor(fy).astype(jnp.int32)
            ax = fx - x1
            ay = fy - y1
            i00 = flat[(y1 * w + x1)]
            i01 = flat[(y1 * w + x1 + 1)]
            i10 = flat[((y1 + 1) * w + x1)]
            i11 = flat[((y1 + 1) * w + x1 + 1)]
            return (i00 * (1 - ax) + i01 * ax) * (1 - ay) + (
                i10 * (1 - ax) + i11 * ax
            ) * ay
        tx = jnp.clip(jnp.rint(rx).astype(jnp.int32), 0, w - 1)
        ty = jnp.clip(jnp.rint(ry).astype(jnp.int32), 0, h - 1)
        return flat[(ty * w + tx)]

    va = sample(*rotated(pax, pay))                      # (N, 256)
    vb = sample(*rotated(pbx, pby))
    bits = (va > vb)                                     # reference brief.wgsl:62

    words = bits.reshape(-1, 8, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)
    return jnp.where(valid[:, None], desc, jnp.uint32(0))
