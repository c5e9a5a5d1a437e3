"""Homography estimation and decomposition — the planar half of two-view
initialization.

A quasi-planar scene (one wall filling the view) makes the essential matrix
degenerate (a one-parameter family of E's fits coplanar points, and RANSAC
picks an arbitrary wrong member).  ORB-SLAM-class systems therefore estimate
BOTH a homography H and an essential E at bootstrap and select by inlier
score; this module provides the H side: batched 4-point DLT hypotheses,
LO-RANSAC, and the Faugeras-Lustman SVD decomposition of a calibrated H into
(R, t, n) candidates.

Convention: x2 ~ H x1 in normalized image coordinates; for a plane
n^T X = d in camera 1, H = R + t n^T / d where X2 = R X1 + t.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _homog(x):
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def four_point_homography(
    x1: jax.Array, x2: jax.Array, weights: jax.Array | None = None
) -> jax.Array:
    """Weighted DLT homography (N >= 4), Hartley-normalized, batched.

    x1, x2: (..., N, 2).  Returns (..., 3, 3) with H[2,2] ~ scale-free.
    """
    if weights is None:
        w = jnp.ones_like(x1[..., 0])
    else:
        w = weights
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)

    def norm(x):
        mean = jnp.sum(x * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
        d = jnp.linalg.norm(x - mean, axis=-1)
        md = jnp.sum(d * w, axis=-1, keepdims=True) / wsum
        s = jnp.sqrt(2.0) / jnp.maximum(md, 1e-9)
        return (x - mean) * s[..., None], mean[..., 0, :], s[..., 0]

    x1n, c1, s1 = norm(x1)
    x2n, c2, s2 = norm(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], axis=-1)
    r2 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], axis=-1)
    A = jnp.concatenate([r1 * w[..., None], r2 * w[..., None]], axis=-2)
    # Null vector via eigh of the 9x9 normal matrix (no SVD in compiled
    # paths, geometry/linalg.py); the Hartley normalization above keeps the
    # squared condition number survivable in f32.
    from tinyslam.geometry.linalg import null_vector

    h = null_vector(A)
    Hn = h.reshape(*h.shape[:-1], 3, 3)

    def T(c, s):
        zz = jnp.zeros_like(s)
        oo = jnp.ones_like(s)
        return jnp.stack(
            [
                jnp.stack([s, zz, -s * c[..., 0]], axis=-1),
                jnp.stack([zz, s, -s * c[..., 1]], axis=-1),
                jnp.stack([zz, zz, oo], axis=-1),
            ],
            axis=-2,
        )

    # x2n = Hn x1n with x_in = T_i x_i  =>  H = T2^-1 Hn T1.
    T2inv = T(c2, s2)
    # inverse of the similarity T: scale 1/s, translation +c
    s2e = s2[..., None, None]
    T2i = jnp.zeros_like(T2inv)
    T2i = T2i.at[..., 0, 0].set(1.0 / s2)
    T2i = T2i.at[..., 1, 1].set(1.0 / s2)
    T2i = T2i.at[..., 2, 2].set(1.0)
    T2i = T2i.at[..., 0, 2].set(c2[..., 0])
    T2i = T2i.at[..., 1, 2].set(c2[..., 1])
    H = T2i @ Hn @ T(c1, s1)
    # Normalize by middle singular value sign-free scale: use H[2,2]-free norm.
    return H / jnp.maximum(jnp.linalg.norm(H, axis=(-2, -1), keepdims=True), 1e-12)


def homography_transfer_error(H: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Symmetric squared transfer error (..., N) in normalized coords."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    Hx1 = jnp.einsum("...ij,...nj->...ni", H, h1)
    Hinv = jnp.linalg.inv(H + 1e-12 * jnp.eye(3, dtype=H.dtype))
    Hix2 = jnp.einsum("...ij,...nj->...ni", Hinv, h2)
    p12 = Hx1[..., :2] / jnp.where(
        jnp.abs(Hx1[..., 2:3]) > 1e-9, Hx1[..., 2:3], 1e-9
    )
    p21 = Hix2[..., :2] / jnp.where(
        jnp.abs(Hix2[..., 2:3]) > 1e-9, Hix2[..., 2:3], 1e-9
    )
    e12 = jnp.sum((p12 - x2) ** 2, axis=-1)
    e21 = jnp.sum((p21 - x1) ** 2, axis=-1)
    return e12 + e21


@functools.partial(
    jax.jit,
    static_argnames=("num_hypotheses", "refine_iters", "lo_candidates"),
)
def ransac_homography(
    key: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    valid: jax.Array,
    inlier_threshold: float = 2e-3,
    num_hypotheses: int = 512,
    refine_iters: int = 2,
    lo_candidates: int = 8,
) -> dict[str, jax.Array]:
    """Batched LO-RANSAC for H (structure mirrors ransac_essential)."""
    thresh2 = 2.0 * inlier_threshold * inlier_threshold  # symmetric (2 terms)
    wide2 = 16.0 * thresh2

    order = jnp.argsort(~valid)
    x1c = x1[order]
    x2c = x2[order]
    count = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)

    u = jax.random.uniform(key, (num_hypotheses, 4))
    idx = jnp.minimum((u * count).astype(jnp.int32), count - 1)
    H = four_point_homography(x1c[idx], x2c[idx])
    errs = homography_transfer_error(H, x1[None], x2[None])
    wide_scores = jnp.sum(((errs < wide2) & valid[None]).astype(jnp.int32), axis=1)

    k = lo_candidates
    topk = jnp.argsort(-wide_scores)[:k]
    x1b = jnp.broadcast_to(x1, (k, *x1.shape))
    x2b = jnp.broadcast_to(x2, (k, *x2.shape))
    pool = [H[topk]]
    err_k = errs[topk]
    for _ in range(refine_iters):
        w = ((err_k < wide2) & valid[None]).astype(jnp.float32)
        H_r = four_point_homography(x1b, x2b, w)
        err_k = homography_transfer_error(H_r, x1[None], x2[None])
        pool.append(H_r)

    H_pool = jnp.concatenate(pool, axis=0)
    err_pool = homography_transfer_error(H_pool, x1[None], x2[None])
    tight = jnp.sum(((err_pool < thresh2) & valid[None]).astype(jnp.int32), axis=1)
    best = jnp.argmax(tight)
    H_best = H_pool[best]
    err = homography_transfer_error(H_best, x1, x2)
    inliers = (err < thresh2) & valid
    return {
        "H": H_best,
        "inliers": inliers,
        "num_inliers": jnp.sum(inliers.astype(jnp.int32)),
    }


def decompose_homography(H: jax.Array):
    """Faugeras-Lustman SVD decomposition of a calibrated homography.

    Returns (Rs (8, 3, 3), ts (8, 3), ns (8, 3)): the 4 sign cases for the
    d > 0 family and 4 for d < 0.  t is scaled so |t| relates to the plane
    distance (scale-free overall, as always for mono).  Cheirality + support
    select the true one downstream.
    """
    from tinyslam.geometry.linalg import svd3

    u, lam, vt = svd3(H)
    s = jnp.linalg.det(u) * jnp.linalg.det(vt)
    d1, d2, d3 = lam[0], lam[1], lam[2]
    # Normalize singular values by d2.
    a = d1 / d2
    c = d3 / d2
    denom = jnp.maximum(a * a - c * c, 1e-12)
    x1m = jnp.sqrt(jnp.clip((a * a - 1.0) / denom, 0.0, None))
    x3m = jnp.sqrt(jnp.clip((1.0 - c * c) / denom, 0.0, None))
    V = jnp.swapaxes(vt, -1, -2)

    Rs, ts, ns = [], [], []
    # Case d' = +d2: R' = rot about y by theta.
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1v = e1 * x1m
            x3v = e3 * x3m
            sin_t = (a - c) * x1v * x3v
            cos_t = a * x3v * x3v + c * x1v * x1v
            Rp = jnp.asarray(
                [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], H.dtype
            )
            Rp = jnp.stack(
                [
                    jnp.stack([cos_t, jnp.zeros_like(cos_t), -sin_t]),
                    jnp.stack([jnp.zeros_like(cos_t), jnp.ones_like(cos_t), jnp.zeros_like(cos_t)]),
                    jnp.stack([sin_t, jnp.zeros_like(cos_t), cos_t]),
                ]
            )
            tp = (a - c) * jnp.stack([x1v, jnp.zeros_like(x1v), -x3v])
            npl = jnp.stack([x1v, jnp.zeros_like(x1v), x3v])
            Rs.append(s * u @ Rp @ vt)
            ts.append(u @ tp)
            ns.append(V @ npl)
    # Case d' = -d2: R'' = rot about y by phi with reflection.
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1v = e1 * x1m
            x3v = e3 * x3m
            sin_p = (a + c) * x1v * x3v
            cos_p = a * x3v * x3v - c * x1v * x1v
            Rp = jnp.stack(
                [
                    jnp.stack([cos_p, jnp.zeros_like(cos_p), sin_p]),
                    jnp.stack([jnp.zeros_like(cos_p), -jnp.ones_like(cos_p), jnp.zeros_like(cos_p)]),
                    jnp.stack([sin_p, jnp.zeros_like(cos_p), -cos_p]),
                ]
            )
            tp = (a + c) * jnp.stack([x1v, jnp.zeros_like(x1v), x3v])
            npl = jnp.stack([x1v, jnp.zeros_like(x1v), x3v])
            Rs.append(s * u @ Rp @ vt)
            ts.append(u @ tp)
            ns.append(V @ npl)
    return jnp.stack(Rs), jnp.stack(ts), jnp.stack(ns)


@jax.jit
def recover_pose_homography(
    H: jax.Array, x1: jax.Array, x2: jax.Array, inliers: jax.Array
) -> dict[str, jax.Array]:
    """Pick the (R, t) candidate from decompose_homography by cheirality
    support (triangulated depth positive in both views), normalized |t| = 1."""
    from tinyslam.geometry.epipolar import depths, triangulate
    from tinyslam.geometry.se3 import se3_identity

    Rs, ts, ns = decompose_homography(H)
    tn = jnp.linalg.norm(ts, axis=-1, keepdims=True)
    ts = ts / jnp.maximum(tn, 1e-9)
    R_id, t_id = se3_identity(dtype=H.dtype)

    def score(R, t):
        X = triangulate(R_id, t_id, x1, R, t, x2)
        z1 = X[..., 2]
        z2 = depths(R, t, X)
        good = (z1 > 0) & (z2 > 0) & inliers
        return jnp.sum(good.astype(jnp.int32)), X, good

    votes, Xs, goods = jax.vmap(score)(Rs, ts)
    best = jnp.argmax(votes)
    return {
        "R": Rs[best],
        "t": ts[best],
        "n": ns[best],
        "points": Xs[best],
        "good": goods[best],
        "votes": votes[best],
    }
