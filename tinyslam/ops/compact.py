"""Deterministic feature compaction: dense score map -> fixed-capacity list.

Replaces the reference's two-level atomic compaction (workgroup atomicAdd +
global range reservation, reference src/shaders/fast.wgsl:122-147).  Atomics
give a nondeterministic feature order and an un-ranked, first-come selection
when the buffer fills; ``jax.lax.top_k`` over the score map is deterministic
(same input => bit-identical output, testable in CI — SURVEY §5 'race
detection') and keeps the *best* k corners instead of an arbitrary subset.

Also adds sub-pixel corner localization (quadratic fit on the raw score
map), which the reference lacks entirely — integer corner quantization is a
dominant error source for downstream pose estimation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _subpixel_offset(flat: jax.Array, idx: jax.Array, stride: int,
                     n: int) -> jax.Array:
    """1D quadratic-fit offset along a flat-index stride, clipped to +-0.5."""
    lo = jnp.clip(idx - stride, 0, n - 1)
    hi = jnp.clip(idx + stride, 0, n - 1)
    s0 = flat[idx]
    sl = flat[lo]
    sr = flat[hi]
    denom = sl - 2.0 * s0 + sr
    off = 0.5 * (sl - sr) / jnp.where(jnp.abs(denom) > 1e-9, denom, 1e9)
    return jnp.clip(off, -0.5, 0.5)


def select_topk(
    score_sel: jax.Array,
    score_raw: jax.Array,
    m10: jax.Array,
    m01: jax.Array,
    k: int,
) -> dict[str, jax.Array]:
    """Select the k highest-scoring pixels of one pyramid level.

    Args:
      score_sel: (H, W) selection score map (post-NMS: 0 = not selected).
      score_raw: (H, W) raw pre-NMS score map, used for sub-pixel quadratic
        refinement (NMS zeroes the neighbours the fit needs).
      m10, m01: (H, W) centroid moments from ops.fast.fast_score_map.
      k: static capacity.

    Returns dict with:
      xy:    (k, 2) float32 sub-pixel (x, y) in this level's pixel coords.
      angle: (k,) float32 atan2(m01, m10) — computed only at the k selected
             pixels (the reference runs atan2 per candidate, fast.wgsl:115).
      score: (k,) float32.
      valid: (k,) bool — score > 0.
    """
    h, w = score_sel.shape
    flat_sel = score_sel.reshape(-1)
    flat_raw = score_raw.reshape(-1)
    n = flat_sel.shape[0]
    vals, idx = jax.lax.top_k(flat_sel, k)
    y = idx // w
    x = idx % w
    valid = vals > 0.0
    dx = _subpixel_offset(flat_raw, idx, 1, n)
    dy = _subpixel_offset(flat_raw, idx, w, n)
    ang = jnp.arctan2(m01.reshape(-1)[idx], m10.reshape(-1)[idx])
    xy = jnp.stack(
        [x.astype(jnp.float32) + dx, y.astype(jnp.float32) + dy], axis=-1
    )
    return {
        "xy": jnp.where(valid[:, None], xy, 0.0),
        "angle": jnp.where(valid, ang, 0.0),
        "score": jnp.where(valid, vals, 0.0),
        "valid": valid,
    }
