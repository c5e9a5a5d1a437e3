"""Brute-force Hamming matching as a matrix product.

The reference has no matcher (matching is unchecked roadmap,
reference README.md:53-57).  The formulation (SURVEY §7): a 256-bit
descriptor becomes a length-256 vector of {-1, +1} int8; then

    dot(a, b) = 256 - 2 * hamming(a, b)
    hamming   = (256 - dot) / 2

so the all-pairs Hamming matrix is a single (N, 256) x (256, M) int8
``dot_general`` on the tensor cores instead of an XOR+popcount loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinyslam.ops.match_pallas import (
    GATE_CLIP, PEN, gate_coords, gate_radius2, match_reduce_fused,
)
from tinyslam.types import descriptor_signs

_BIG = jnp.int32(1 << 14)  # sentinel distance for invalid slots (> 256)


def hamming_distance_matrix(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """(N, 8) x (M, 8) packed uint32 -> (N, M) int32 Hamming distances."""
    sa = descriptor_signs(desc_a)                      # (N, 256) int8
    sb = descriptor_signs(desc_b)                      # (M, 256) int8
    dot = jax.lax.dot_general(
        sa, sb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )                                                  # (N, M)
    return (256 - dot) // 2


def matcher_path(max_distance: int, ratio: float,
                 backend: str | None = None) -> str:
    """The one place that chooses the matcher: ``"triton"`` (the fused kernel
    of ops/match_pallas.py) or ``"xla"`` (the reference path below).

    The kernel runs on the GPU backend when the config is inside its
    penalty envelope: a real distance must never beat a penalized one
    (max_distance < PEN) and a penalized second best must never tighten the
    ratio test (ratio * PEN >= 256).  Any shape is eligible (the kernel
    pads); legal configs outside the envelope (e.g. ratio 0.7) take the XLA
    path.
    """
    backend = backend or jax.default_backend()
    eligible = backend == "gpu" and _in_envelope(max_distance, ratio)
    return "triton" if eligible else "xla"


def _in_envelope(max_distance: int, ratio: float) -> bool:
    return max_distance < PEN and ratio * PEN >= 256


@functools.partial(jax.jit, static_argnames=(
    "max_distance", "ratio", "cross_check", "radius_px", "kernel",
    "interpret"))
def match_descriptors(
    desc_a: jax.Array,
    valid_a: jax.Array,
    desc_b: jax.Array,
    valid_b: jax.Array,
    max_distance: int = 64,
    ratio: float = 0.9,
    cross_check: bool = True,
    pair_mask: jax.Array | None = None,
    xy_a: jax.Array | None = None,
    proj_b: jax.Array | None = None,
    radius_px: float = 0.0,
    kernel: bool = True,
    interpret: bool = False,
) -> dict[str, jax.Array]:
    """Mutual-nearest Hamming matching with Lowe ratio test.

    Guided matching (map points only eligible near their predicted
    projection) comes in two equivalent forms:
      - `pair_mask` (N, M) bool — explicit, materialized (XLA path);
      - `xy_a` (N, 2) + `proj_b` (M, 2) + `radius_px` — the gate computed
        on the fly (encode ineligible B entries, e.g. behind-camera
        landmarks, with a far-away proj coordinate).
    Restricting candidates both removes wrong matches and makes the ratio
    test meaningful under repetitive texture.

    The gate is decided in integers on a sub-pixel grid
    (``match_pallas.gate_coords``), so both paths below decide it alike.

    Where ``matcher_path`` picks the fused kernel (ops/match_pallas.py) the
    (N, M) distance matrix never reaches device memory.  The XLA path below
    is the reference semantics; both agree bit for bit on all valid rows.
    ``kernel=False`` forces the XLA reference and ``interpret=True`` the
    kernel in Pallas interpret mode (parity checks and tests on the CPU).

    Returns dict with
      idx_b:  (N,) int32 — best match in B for each A feature.
      dist:   (N,) int32 — its Hamming distance.
      valid:  (N,) bool  — passes distance bound, ratio test and cross-check.
    """
    with jax.named_scope("match"):     # groups the matcher's ops in a trace
        n, m = desc_a.shape[0], desc_b.shape[0]
        guided_stream = xy_a is not None and proj_b is not None
        use_kernel = pair_mask is None and (interpret or (
            kernel and matcher_path(max_distance, ratio) == "triton"))
        if use_kernel:
            if not _in_envelope(max_distance, ratio):
                raise ValueError(
                    f"max_distance={max_distance}, ratio={ratio} is outside "
                    "the fused matcher's penalty envelope")
            pen_a = jnp.where(valid_a, 0, PEN).astype(jnp.int32)
            pen_b = jnp.where(valid_b, 0, PEN).astype(jnp.int32)
            if guided_stream:
                uv_a, uv_b = gate_coords(xy_a).T, gate_coords(proj_b).T
            else:
                uv_a = jnp.zeros((2, n), jnp.int32)
                uv_b = jnp.zeros((2, m), jnp.int32)
            best, second, idx_b, col_idx = match_reduce_fused(
                descriptor_signs(desc_a), pen_a, uv_a,
                descriptor_signs(desc_b), pen_b, uv_b,
                radius_px=float(radius_px), guided=guided_stream,
                interpret=interpret)
            ok = best <= max_distance
            ok &= (best.astype(jnp.float32)
                   <= ratio * second.astype(jnp.float32))
            if cross_check:
                ok &= col_idx[idx_b] == jnp.arange(n)
            ok &= valid_a
            return {"idx_b": idx_b, "dist": jnp.minimum(best, _BIG),
                    "valid": ok}

        if guided_stream and pair_mask is None:
            dq = gate_coords(xy_a)[:, None, :] - gate_coords(proj_b)[None]
            dq = jnp.clip(dq, -GATE_CLIP, GATE_CLIP)
            pair_mask = jnp.sum(dq * dq, axis=-1) < gate_radius2(radius_px)

        d = hamming_distance_matrix(desc_a, desc_b)        # (N, M)
        d = jnp.where(valid_a[:, None] & valid_b[None, :], d, _BIG)
        if pair_mask is not None:
            d = jnp.where(pair_mask, d, _BIG)

        idx_b = jnp.argmin(d, axis=1)                      # (N,)
        best = jnp.min(d, axis=1)
        # Second best: mask out the winner column per row.
        n = d.shape[0]
        d2 = d.at[jnp.arange(n), idx_b].set(_BIG)
        second = jnp.min(d2, axis=1)

        ok = best <= max_distance
        ok &= (best.astype(jnp.float32)
               <= ratio * second.astype(jnp.float32))
        if cross_check:
            idx_a_of_b = jnp.argmin(d, axis=0)             # (M,)
            ok &= idx_a_of_b[idx_b] == jnp.arange(n)
        ok &= valid_a
        return {"idx_b": idx_b, "dist": best, "valid": ok}
