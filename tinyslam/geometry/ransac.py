"""Batched RANSAC for two-view relative pose (BASELINE config 2).

Batched shape: instead of the classic sequential hypothesize-and-verify loop,
ALL hypotheses are drawn up front and solved as one batched 8-point problem
(one (S, 9, 9) eigh), scored as one (S, N) Sampson evaluation, and reduced
with argmax — no data-dependent control flow, fully jit/vmap/pmap-able.
Degenerate samples (duplicates, collinear) simply produce low-scoring
hypotheses and are out-voted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinyslam.geometry.epipolar import (
    decompose_essential,
    depths,
    eight_point_essential,
    sampson_error,
    triangulate,
)
from tinyslam.geometry.se3 import se3_identity, so3_exp, so3_hat


@functools.partial(
    jax.jit,
    static_argnames=("num_hypotheses", "sample_size", "refine_iters", "lo_candidates"),
)
def ransac_essential(
    key: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    valid: jax.Array,
    inlier_threshold: float = 2e-3,
    num_hypotheses: int = 1024,
    sample_size: int = 8,
    refine_iters: int = 2,
    lo_candidates: int = 16,
) -> dict[str, jax.Array]:
    """Robust essential-matrix estimation (batched LO-RANSAC).

    Structure: minimal 8-point hypotheses are scored with a WIDENED Sampson
    threshold (4x distance) — minimal samples under pixel noise produce E's
    that recover only a fraction of true inliers at the tight threshold, so
    wide scoring is a far less noisy hypothesis ranking.  The top
    ``lo_candidates`` hypotheses then get ``refine_iters`` batched
    local-optimization rounds (refit on their wide inliers), and the winner
    is chosen by TIGHT-threshold score over the whole pool — refinement can
    never make the result worse than the best raw hypothesis.

    Args:
      key: PRNG key.
      x1, x2: (N, 2) normalized correspondences (invalid slots arbitrary).
      valid: (N,) bool.
      inlier_threshold: Sampson distance bound (normalized coords).

    Returns dict with E (3,3), inliers (N,) bool, num_inliers ().
    """
    thresh2 = inlier_threshold * inlier_threshold
    wide2 = 16.0 * thresh2  # 4x distance

    # Compact valid correspondences to the front so uniform index sampling
    # hits only (mostly) valid pairs.  argsort of the inverted mask is a
    # stable partition — deterministic given the input.
    order = jnp.argsort(~valid)
    x1c = x1[order]
    x2c = x2[order]
    count = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)

    u = jax.random.uniform(key, (num_hypotheses, sample_size))
    idx = jnp.minimum((u * count).astype(jnp.int32), count - 1)
    s1 = x1c[idx]                                     # (S, m, 2)
    s2 = x2c[idx]

    E = eight_point_essential(s1, s2)                 # (S, 3, 3)
    errs = sampson_error(E, x1[None], x2[None])       # (S, N) squared Sampson
    wide_scores = jnp.sum(((errs < wide2) & valid[None]).astype(jnp.int32), axis=1)

    # Local optimization: batched refits of the top-K wide-score hypotheses.
    k = lo_candidates
    topk = jnp.argsort(-wide_scores)[:k]
    x1b = jnp.broadcast_to(x1, (k, *x1.shape))
    x2b = jnp.broadcast_to(x2, (k, *x2.shape))
    pool = [E[topk]]
    err_k = errs[topk]
    for _ in range(refine_iters):
        w = ((err_k < wide2) & valid[None]).astype(jnp.float32)
        E_r = eight_point_essential(x1b, x2b, w)      # (k, 3, 3)
        err_k = sampson_error(E_r, x1[None], x2[None])
        pool.append(E_r)

    E_pool = jnp.concatenate(pool, axis=0)            # (k*(1+iters), 3, 3)
    err_pool = sampson_error(E_pool, x1[None], x2[None])
    tight = jnp.sum(((err_pool < thresh2) & valid[None]).astype(jnp.int32), axis=1)
    E_best = E_pool[jnp.argmax(tight)]

    err = sampson_error(E_best, x1, x2)
    inliers = (err < thresh2) & valid
    return {
        "E": E_best,
        "inliers": inliers,
        "num_inliers": jnp.sum(inliers.astype(jnp.int32)),
    }


@functools.partial(jax.jit, static_argnames=("iters",))
def refine_relative_pose(
    R: jax.Array,
    t: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    valid: jax.Array,
    inlier_threshold: float = 2e-3,
    iters: int = 10,
    damping: float = 1e-6,
) -> tuple[jax.Array, jax.Array]:
    """Gauss-Newton refinement of a relative pose on the essential manifold.

    Minimizes Cauchy-weighted Sampson distance of E(R, t) = [t]_x R over the
    5-DoF (rotation, unit-translation-direction) manifold — the maximum-
    likelihood polish the linear 8-point refits cannot provide (they minimize
    a reweighted algebraic error and plateau well above the noise floor).
    Jacobians come from jax.jacfwd over the 5 tangent parameters.
    """
    thresh2 = inlier_threshold * inlier_threshold

    def signed_sampson(R, t):
        E = so3_hat(t) @ R
        h1 = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
        h2 = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
        Ex1 = h1 @ E.T
        Etx2 = h2 @ E
        num = jnp.sum(h2 * Ex1, axis=-1)
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        return num / jnp.sqrt(jnp.maximum(den, 1e-12))

    def tangent_basis(t):
        # Orthonormal (b1, b2) perpendicular to t, branchless.
        ref = jnp.where(jnp.abs(t[0]) < 0.9, jnp.asarray([1.0, 0.0, 0.0], t.dtype),
                        jnp.asarray([0.0, 1.0, 0.0], t.dtype))
        b1 = jnp.cross(t, ref)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-9)
        b2 = jnp.cross(t, b1)
        return b1, b2

    def step(carry, _):
        R, t = carry
        b1, b2 = tangent_basis(t)

        def residuals(p):
            dR = so3_exp(p[:3])
            tn = t + p[3] * b1 + p[4] * b2
            tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-9)
            return signed_sampson(dR @ R, tn)

        p0 = jnp.zeros(5, x1.dtype)
        r = residuals(p0)
        J = jax.jacfwd(residuals)(p0)                  # (N, 5)
        w = valid.astype(x1.dtype) / (1.0 + (r * r) / thresh2)
        H = (J * w[:, None]).T @ J + damping * jnp.eye(5, dtype=x1.dtype)
        g = (J * w[:, None]).T @ r
        p = -jnp.linalg.solve(H, g)
        dR = so3_exp(p[:3])
        tn = t + p[3] * b1 + p[4] * b2
        tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-9)
        return (dR @ R, tn), None

    (R, t), _ = jax.lax.scan(step, (R, t), None, length=iters)
    return R, t


@jax.jit
def recover_pose(
    E: jax.Array, x1: jax.Array, x2: jax.Array, inliers: jax.Array
) -> dict[str, jax.Array]:
    """Cheirality disambiguation of the 4 (R, t) candidates from E.

    Camera 1 is [I|0]; returns the camera-2 pose (R, t) with |t| = 1 (scale
    is unobservable from two views), the triangulated points for the winning
    candidate, and the per-point positive-depth mask.
    """
    R1, R2, t = decompose_essential(E)
    Rs = jnp.stack([R1, R1, R2, R2])                  # (4, 3, 3)
    ts = jnp.stack([t, -t, t, -t])                    # (4, 3)

    R_id, t_id = se3_identity(dtype=E.dtype)

    def score(R, tt):
        X = triangulate(R_id, t_id, x1, R, tt, x2)    # (N, 3)
        z1 = X[..., 2]
        z2 = depths(R, tt, X)
        good = (z1 > 0) & (z2 > 0) & inliers
        return jnp.sum(good.astype(jnp.int32)), X, good

    votes, Xs, goods = jax.vmap(score)(Rs, ts)
    best = jnp.argmax(votes)
    return {
        "R": Rs[best],
        "t": ts[best],
        "points": Xs[best],
        "good": goods[best],
        "votes": votes[best],
    }
