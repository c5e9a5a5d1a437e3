"""Small-matrix factorizations without SVD.

``jnp.linalg.svd`` lowers to a large iterative XLA program whose compile
time grows quickly with each distinct shape, while eigh / cholesky / qr /
solve compile fast.  Every factorization this framework needs in a compiled
path is tiny (3x3 .. 12x12) and has an eigh/cholesky/elementwise
formulation, so SVD is banned from jitted code:

- null spaces        -> eigh of the normal matrix (Hartley-normalize first:
                        eigh squares the condition number, normalization
                        gives most of that precision back);
- nearest rotation   -> Newton polar iteration (X <- (X + X^-T)/2) with a
                        closed-form 3x3 inverse — converges quadratically,
                        compiles to elementwise ops;
- 3x3 SVD            -> assembled from eigh(M^T M): V from the eigvecs,
                        singular values from the eigvalues, U = M V / sigma
                        (cross-product fallback for the null direction).

Everything here is batched (leading dims broadcast) and jit/vmap-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def smallest_eigvecs(M: jax.Array, k: int) -> jax.Array:
    """The k eigenvectors of symmetric M (..., n, n) with SMALLEST
    eigenvalues, as columns (..., n, k).  eigh returns ascending order."""
    _, vecs = jnp.linalg.eigh(M)
    return vecs[..., :k]


def refine_null_space(M: jax.Array, B: jax.Array, iters: int = 2,
                      eps_scale: float = 1e-8) -> jax.Array:
    """Subspace inverse iteration: sharpen an approximate (near-)null-space
    basis B (..., n, k) of symmetric PSD M (..., n, n).

    eigh on the normal matrix leaves ~sqrt(eps_f32)-level error in the
    smallest eigenvectors (the squared condition number); one or two rounds
    of solve-and-reorthonormalize against M + eps*I amplify the null
    directions by ~1/eps and recover SVD-grade accuracy at eigh-grade
    compile cost (LU solve and QR compile fast; SVD does not).
    """
    n = M.shape[-1]
    tr = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None]
    Mr = M + (eps_scale / n) * tr * jnp.eye(n, dtype=M.dtype)
    for _ in range(iters):
        B = jnp.linalg.solve(Mr, B)
        B, _ = jnp.linalg.qr(B)
    return B


def exact_null_space(A: jax.Array, k: int) -> jax.Array:
    """Null-space basis (..., n, k) of a MINIMAL system A (..., m, n) with
    m = n - k independent rows: the last k columns of the complete QR of
    A^T span the orthogonal complement of A's row space exactly — full f32
    accuracy with no condition-number squaring, and QR compiles fast where
    SVD does not.

    Only valid when the null space has exact dimension >= k (minimal
    solvers); least-squares null spaces of overdetermined noisy systems
    need null_vector/smallest_eigvecs instead.
    """
    q, _ = jnp.linalg.qr(jnp.swapaxes(A, -1, -2), mode="complete")
    return q[..., -k:]


def null_vector(A: jax.Array) -> jax.Array:
    """Least-squares null vector of A (..., m, n): the right singular vector
    of the smallest singular value, via eigh(A^T A) + inverse-iteration
    polish.  Returns (..., n)."""
    M = jnp.einsum("...ki,...kj->...ij", A, A)
    v = smallest_eigvecs(M, 1)
    return refine_null_space(M, v)[..., 0]


def _inv3(A: jax.Array) -> jax.Array:
    """Closed-form (adjugate) 3x3 inverse — elementwise ops only."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def polar_rotation3(M: jax.Array, iters: int = 9) -> jax.Array:
    """Orthogonal polar factor of M (..., 3, 3) by Newton iteration
    X <- (X + X^-T)/2.  det(result) = sign(det(M)); callers wanting a
    proper rotation multiply by det (odd dimension: -U flips det).

    Initial Frobenius scaling keeps the first steps well-conditioned.
    Singular M yields non-finite output — in RANSAC settings such
    hypotheses score zero votes and lose, matching SVD-path behavior."""
    nrm = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1), keepdims=True))
    X = M / jnp.maximum(nrm, 1e-30) * jnp.sqrt(3.0)
    for _ in range(iters):
        X = 0.5 * (X + jnp.swapaxes(_inv3(X), -1, -2))
    return X


def svd3(M: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """SVD of M (..., 3, 3) assembled from eigh(M^T M).

    Returns (u, s, vt) with s descending, matching ``jnp.linalg.svd``'s
    contract closely enough for geometric use: M = u @ diag(s) @ vt (exact
    for full-rank M; for rank-2 M the null left vector is u0 x u1, so
    reconstruction still holds since s[2] = 0).  Columns of u/rows of vt
    carry arbitrary-but-consistent signs, exactly as any SVD does."""
    MtM = jnp.einsum("...ki,...kj->...ij", M, M)
    _, V = jnp.linalg.eigh(MtM)                          # ascending
    V = V[..., ::-1]                                     # descending columns
    MV = jnp.einsum("...ij,...jk->...ik", M, V)          # (..., 3, 3)
    # Singular values as |M v_i| — exact for exact eigenvectors, and far
    # more accurate than sqrt(eigenvalue) when sigma^2 sits at the f32
    # noise floor of the squared matrix (an exact essential matrix has
    # eigh lambda_3 ~ 1e-9 * lambda_1, i.e. pure rounding noise).
    s = jnp.linalg.norm(MV, axis=-2)
    U = MV / jnp.maximum(s, 1e-30)[..., None, :]
    # Rank-deficient direction: |M v_2| at rounding level carries no
    # directional information — complete the frame with the cross product.
    u2_cross = jnp.cross(U[..., :, 0], U[..., :, 1], axis=-1)
    tiny = (s[..., 2] < 1e-4 * jnp.maximum(s[..., 0], 1e-30))[..., None]
    u2 = jnp.where(tiny, u2_cross, U[..., :, 2])
    U = jnp.concatenate([U[..., :, :2], u2[..., :, None]], axis=-1)
    return U, s, jnp.swapaxes(V, -1, -2)
