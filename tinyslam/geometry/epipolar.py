"""Two-view epipolar geometry: essential matrix, triangulation.

All functions are batched and jit-safe; the 8-point solver vmaps over RANSAC
hypotheses as one batched solve (no per-hypothesis control flow) — the
batched shape of "5-point RANSAC" from BASELINE config 2.

Convention: correspondences are in *normalized image coordinates*
(K^-1 pixels).  For cameras P1 = [I|0] and P2 = [R|t] (x2 in camera-2 of a
point seen at x1 in camera-1), the constraint is x2^T E x1 = 0 with
E = [t]_x R.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinyslam.geometry.se3 import so3_hat


def _homog(x: jax.Array) -> jax.Array:
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def essential_from_pose(R: jax.Array, t: jax.Array) -> jax.Array:
    """E = [t]_x R (up to scale)."""
    return so3_hat(t) @ R


def eight_point_essential(
    x1: jax.Array, x2: jax.Array, weights: jax.Array | None = None
) -> jax.Array:
    """Weighted 8-point essential estimate.

    Args:
      x1, x2: (..., N, 2) normalized correspondences (N >= 8).
      weights: (..., N) optional nonnegative weights (0 disables a row).

    Returns: (..., 3, 3) essential matrix projected onto the essential
    manifold (singular values (1, 1, 0)).

    Points are Hartley-normalized (centered, scaled to mean distance sqrt(2))
    before the solve — essential for float32: the eigh runs on the squared
    normal matrix, so conditioning of A matters twice.
    """
    if weights is None:
        w_norm = jnp.ones_like(x1[..., 0])
    else:
        w_norm = weights
    wsum = jnp.maximum(jnp.sum(w_norm, axis=-1, keepdims=True), 1e-9)

    def norm_transform(x):
        mean = jnp.sum(x * w_norm[..., None], axis=-2, keepdims=True) / wsum[..., None]
        d = jnp.linalg.norm(x - mean, axis=-1)
        mean_d = jnp.sum(d * w_norm, axis=-1, keepdims=True) / wsum
        s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-9)
        return (x - mean) * s[..., None], mean[..., 0, :], s

    x1n, c1, s1 = norm_transform(x1)
    x2n, c2, s2 = norm_transform(x2)

    h1 = _homog(x1n)                                   # (..., N, 3)
    h2 = _homog(x2n)
    # Row for pair i: kron(h2_i, h1_i) . vec(E) = 0 with vec row-major.
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*h1.shape[:-1], 9)
    if weights is not None:
        A = A * weights[..., None]
    # Null vector via eigh of the 9x9 normal matrix (geometry/linalg.py: no
    # SVD in compiled paths — its compile time is large per shape).  The normal
    # matrix squares the condition number; the Hartley normalization above
    # is what keeps the f32 null space recoverable for minimal samples.
    from tinyslam.geometry.linalg import null_vector

    e = null_vector(A)
    En = e.reshape(*e.shape[:-1], 3, 3)
    # Denormalize: x2^T E x1 = x2n^T En x1n with xin = Ti xi  =>  E = T2^T En T1.
    def T(c, s):
        z = jnp.zeros_like(s)
        o = jnp.ones_like(s)
        return jnp.stack(
            [
                jnp.stack([s, z, -s * c[..., 0]], axis=-1),
                jnp.stack([z, s, -s * c[..., 1]], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )

    s1 = s1[..., 0]
    s2 = s2[..., 0]
    E = jnp.swapaxes(T(c2, s2), -1, -2) @ En @ T(c1, s1)
    # Project to the essential manifold (singular values -> (1, 1, 0)).
    from tinyslam.geometry.linalg import svd3

    u, s, vt2 = svd3(E)
    sig = jnp.ones_like(s).at[..., 2].set(0.0)
    return (u * sig[..., None, :]) @ vt2


def sampson_error(E: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) error of x2^T E x1 = 0.

    E: (..., 3, 3); x1, x2: (..., N, 2) normalized. Returns (..., N).
    """
    h1 = _homog(x1)
    h2 = _homog(x2)
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, h1)      # (..., N, 3)
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, h2)
    num = jnp.einsum("...ni,...ni->...n", h2, Ex1)
    den = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    return (num * num) / jnp.maximum(den, 1e-12)


def decompose_essential(E: jax.Array):
    """E -> two rotations and the unit translation: the four candidate poses
    are (R1, +-t), (R2, +-t)."""
    from tinyslam.geometry.linalg import svd3

    u, _, vt = svd3(E)
    # Enforce proper rotations.
    du = jnp.linalg.det(u)[..., None, None]
    dv = jnp.linalg.det(vt)[..., None, None]
    u = u * jnp.concatenate([jnp.ones_like(du), jnp.ones_like(du), du], axis=-1)
    vt = vt * jnp.concatenate([jnp.ones_like(dv), jnp.ones_like(dv), dv], axis=-2)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    return R1, R2, t


def triangulate(
    R1: jax.Array, t1: jax.Array, x1: jax.Array,
    R2: jax.Array, t2: jax.Array, x2: jax.Array,
    eps: float = 1e-9,
) -> jax.Array:
    """Linear triangulation of N correspondences.

    Cameras map world->camera: Xc = R X + t.  x1, x2: (..., N, 2) normalized
    observations.  Returns world points (..., N, 3).

    Solved as a 3x3 normal-equation system per point (4 linear constraints
    (u * row3 - row1) . X = ... stacked) — einsum + closed 3x3 solve, no SVD,
    fully batched as matrix products.
    """
    def rows(R, t, x):
        # (u * R[2] - R[0]) . X = t[0] - u * t[2]   (and same for v)
        u = x[..., 0:1]
        v = x[..., 1:2]
        r0 = u * R[..., None, 2, :] - R[..., None, 0, :]   # (..., N, 3)
        r1 = v * R[..., None, 2, :] - R[..., None, 1, :]
        b0 = t[..., None, 0] - x[..., 0] * t[..., None, 2]  # (..., N)
        b1 = t[..., None, 1] - x[..., 1] * t[..., None, 2]
        return jnp.stack([r0, r1], axis=-2), jnp.stack([b0, b1], axis=-1)

    A1, b1 = rows(R1, t1, x1)                          # (..., N, 2, 3), (..., N, 2)
    A2, b2 = rows(R2, t2, x2)
    A = jnp.concatenate([A1, A2], axis=-2)             # (..., N, 4, 3)
    b = jnp.concatenate([b1, b2], axis=-1)             # (..., N, 4)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)       # (..., N, 3, 3)
    Atb = jnp.einsum("...ki,...k->...i", A, b)
    AtA = AtA + eps * jnp.eye(3, dtype=A.dtype)
    return jnp.linalg.solve(AtA, Atb[..., None])[..., 0]


def depths(R: jax.Array, t: jax.Array, X: jax.Array) -> jax.Array:
    """z-coordinate of world points X (..., N, 3) in camera (R, t)."""
    return jnp.einsum("...j,...nj->...n", R[..., 2, :], X) + t[..., None, 2]
