"""Schur-complement Levenberg-Marquardt bundle adjustment (BASELINE config 4).

The sparse BA normal equations

    [ U   W ] [dc]   [ gc ]
    [ W^T V ] [dp] = [ gp ]

are solved by eliminating the landmark blocks V (block-diagonal, 3x3 each)
with one vmapped closed-form inverse, reducing to the camera system

    S dc = b,   S = U - W V^-1 W^T,   b = gc - W V^-1 gp

S is (6K x 6K) dense (K <= ~16 keyframes) — one small Cholesky.  Everything
else is einsums over the (L, K) grid: dense work, no sparsity bookkeeping,
no data-dependent shapes.  The L axis is the sharding axis for distributed
BA: each shard computes partial (S, b), psum over the mesh, identical solve on
every device (parallel.dist_ba).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tinyslam.backend.residuals import (
    reprojection_residuals,
    reprojection_residuals_ll,
)
from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.se3 import se3_compose, se3_exp


class BAState(NamedTuple):
    R: jax.Array        # (K, 3, 3)
    t: jax.Array        # (K, 3)
    X: jax.Array        # (3, L) inside the LM scan (landmarks-last)
    lam: jax.Array      # () LM damping
    cost: jax.Array     # () current robust cost
    num_ok: jax.Array   # () active (in-front, visible) residual count


def _robust_weights(r: jax.Array, ok: jax.Array, huber: float):
    """Huber IRLS weights per observation. r (L,K,2) -> w (L,K)."""
    err = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(err > huber, huber / jnp.maximum(err, 1e-9), 1.0)
    return w * ok.astype(r.dtype), err


def _robust_cost(err: jax.Array, ok: jax.Array, huber: float):
    e = jnp.where(ok, err, 0.0)
    quad = 0.5 * e * e
    lin = huber * (e - 0.5 * huber)
    return jnp.sum(jnp.where(e > huber, lin, quad) * ok.astype(err.dtype))


def ba_normal_blocks(cam, R, t, X, z, mask, huber):
    """Build the BA normal-equation blocks.  Separated out so distributed BA
    can run it per landmark shard and psum the pose-side outputs."""
    r, Jc, Jp, ok = reprojection_residuals(cam, R, t, X, z, mask)
    w, err = _robust_weights(r, ok, huber)
    wx = w[..., None]                                   # (L, K, 1)
    # Pose-side (reduce over landmarks -> psum-able).
    U = jnp.einsum("lkia,lkib->kab", Jc * wx[..., None], Jc)     # (K, 6, 6)
    gc = -jnp.einsum("lkia,lki->ka", Jc * wx[..., None], r)      # (K, 6)
    # Landmark-side (stays sharded).
    V = jnp.einsum("lkia,lkib->lab", Jp * wx[..., None], Jp)     # (L, 3, 3)
    gp = -jnp.einsum("lkia,lki->la", Jp * wx[..., None], r)      # (L, 3)
    W = jnp.einsum("lkia,lkib->lkab", Jc * wx[..., None], Jp)    # (L, K, 6, 3)
    cost = _robust_cost(err, ok, huber)
    num_ok = jnp.sum(ok.astype(jnp.int32))
    return U, gc, V, gp, W, cost, num_ok


def schur_reduce(U, gc, V, gp, W, lam, pose_free, preduce=lambda x: x):
    """Eliminate landmarks; returns (S (6K,6K), b (6K,), Vinv_damped).

    `preduce` reduces landmark-summed quantities across devices (identity on
    one chip; ``lax.psum`` over the landmark mesh axis under shard_map —
    the collective of SURVEY §2d).  U and gc must ALREADY be reduced by
    the caller; V/gp/W/Vinv stay shard-local.
    """
    K = U.shape[0]
    # Marquardt damping lam * (diag + eps) on both block diagonals.
    eyeK6 = jnp.eye(6, dtype=U.dtype)
    eyeL3 = jnp.eye(3, dtype=V.dtype)
    Ud = U + lam * (jax.vmap(jnp.diag)(jnp.einsum("kaa->ka", U)) + 1e-6 * eyeK6)
    Vd = V + lam * (jax.vmap(jnp.diag)(jnp.einsum("laa->la", V)) + 1e-6 * eyeL3)
    # Absolute damping floor: bounds the step of weakly-constrained
    # landmarks (near-degenerate V blocks otherwise take ~1e8-sized steps
    # that fling points behind the cameras).
    Vd = Vd + 1e-3 * eyeL3
    Vinv = jnp.linalg.inv(Vd)                           # (L, 3, 3)

    T = jnp.einsum("lkab,lbc->lkac", W, Vinv)           # (L, K, 6, 3)
    S_off = preduce(jnp.einsum("lkac,lmbc->kmab", T, W))  # (K, K, 6, 6)
    S = -S_off
    S = S.at[jnp.arange(K), jnp.arange(K)].add(Ud)
    b = gc - preduce(jnp.einsum("lkac,lc->ka", T, gp))  # (K, 6)

    # Gauge fixing: project out rows/cols of fixed poses, identity on diag.
    free = pose_free.astype(U.dtype)                    # (K,)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        (1.0 - free)[:, None, None] * jnp.eye(6, dtype=U.dtype)
    )
    b = b * free[:, None]

    S_mat = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    b_vec = b.reshape(6 * K)
    return S_mat, b_vec, Vinv


def back_substitute(Vinv, W, gp, dc):
    """Landmark updates from the camera solution: dp = Vinv (gp - W^T dc)."""
    rhs = gp - jnp.einsum("lkab,ka->lb", W, dc)         # (L, 3)
    return jnp.einsum("lab,lb->la", Vinv, rhs)


# ---------------------------------------------------------------------------
# Landmarks-last (L-minor) kernels — the layout the LM scan actually runs.
# The (L, K, blk) variants above are the readable reference; with tiny
# trailing (2, 6)/(3, 3) blocks minor, a tiled memory layout pads each block
# many times over.  With L minor, every build is a wide vector op or an
# L-minor matmul.  Same math, same reduction tree over each block.
# ---------------------------------------------------------------------------


def _inv3x3_ll(M):
    """Closed-form inverse of (3, 3, L) SPD blocks (batched adjugate —
    jnp.linalg.inv's LU loop is both slower and L-major)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e]),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)]),
        jnp.stack([C, -(a * h - b * g), a * e - b * d]),
    ])
    return adj * inv_det


def ba_normal_blocks_ll(cam, R, t, Xt, zt, maskt, huber):
    """Landmarks-last ba_normal_blocks: Xt (3,L), zt (K,2,L), maskt (K,L).

    Returns U (K,6,6), gc (K,6), V (3,3,L), gp (3,L), W (K,6,3,L), cost,
    num_ok — pose-side outputs have the same shapes/semantics as
    ba_normal_blocks so the distributed psum points are unchanged.
    """
    r, Jc, Jp, ok = reprojection_residuals_ll(cam, R, t, Xt, zt, maskt)
    err = jnp.sqrt(jnp.sum(r * r, axis=1) + 1e-18)       # (K, L)
    w = jnp.where(err > huber, huber / jnp.maximum(err, 1e-9), 1.0)
    w = w * ok.astype(r.dtype)                           # (K, L)
    wJc = Jc * w[:, None, None, :]                       # (K, 2, 6, L)
    # Pose-side: contract (i, L) with L minor -> per-k 6x6 matmuls.
    U = jnp.einsum("kial,kibl->kab", wJc, Jc)            # (K, 6, 6)
    gc = -jnp.einsum("kial,kil->ka", wJc, r)             # (K, 6)
    # Landmark-side: contract (k, i), everything stays (…, L).
    wJp = Jp * w[:, None, None, :]                       # (K, 2, 3, L)
    V = jnp.einsum("kial,kibl->abl", wJp, Jp)            # (3, 3, L)
    gp = -jnp.einsum("kial,kil->al", wJp, r)             # (3, L)
    W = jnp.einsum("kial,kibl->kabl", wJc, Jp)           # (K, 6, 3, L)
    e = jnp.where(ok, err, 0.0)
    quad = 0.5 * e * e
    lin = huber * (e - 0.5 * huber)
    cost = jnp.sum(jnp.where(e > huber, lin, quad) * ok.astype(err.dtype))
    num_ok = jnp.sum(ok.astype(jnp.int32))
    return U, gc, V, gp, W, cost, num_ok


def schur_reduce_ll(U, gc, V, gp, W, lam, pose_free, preduce=lambda x: x):
    """Landmarks-last schur_reduce: V (3,3,L), gp (3,L), W (K,6,3,L).
    Same (S, b) as schur_reduce; Vinv returned as (3,3,L)."""
    K = U.shape[0]
    eyeK6 = jnp.eye(6, dtype=U.dtype)
    Ud = U + lam * (jax.vmap(jnp.diag)(jnp.einsum("kaa->ka", U)) + 1e-6 * eyeK6)
    diagV = jnp.stack([V[0, 0], V[1, 1], V[2, 2]])       # (3, L)
    Vd = V + lam * _diag_embed_ll(diagV + 1e-6) + _diag_embed_ll(
        jnp.full_like(diagV, 1e-3))
    Vinv = _inv3x3_ll(Vd)                                # (3, 3, L)

    # T = W Vinv: contract c over 3 — stays (K, 6, 3, L).
    T = jnp.einsum("kacl,cbl->kabl", W, Vinv)
    # S_off = sum_l T W^T: contract (c, L) with L minor -> (K,K,6,6).
    S_off = preduce(jnp.einsum("kacl,mbcl->kmab", T, W))
    S = -S_off
    S = S.at[jnp.arange(K), jnp.arange(K)].add(Ud)
    b = gc - preduce(jnp.einsum("kacl,cl->ka", T, gp))

    free = pose_free.astype(U.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        (1.0 - free)[:, None, None] * jnp.eye(6, dtype=U.dtype)
    )
    b = b * free[:, None]
    return S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K), b.reshape(6 * K), Vinv


def _diag_embed_ll(d):
    """(3, L) diagonals -> (3, 3, L) diagonal blocks."""
    z = jnp.zeros_like(d[0])
    return jnp.stack([
        jnp.stack([d[0], z, z]),
        jnp.stack([z, d[1], z]),
        jnp.stack([z, z, d[2]]),
    ])


def back_substitute_ll(Vinv, W, gp, dc):
    """Landmarks-last back substitution: dp (3, L)."""
    rhs = gp - jnp.einsum("kabl,ka->bl", W, dc)          # (3, L)
    return jnp.einsum("abl,bl->al", Vinv, rhs)


@functools.partial(jax.jit, static_argnames=("max_iters",))
def bundle_adjust(
    cam: PinholeCamera,
    R: jax.Array,         # (K, 3, 3)
    t: jax.Array,         # (K, 3)
    X: jax.Array,         # (L, 3)
    z: jax.Array,         # (L, K, 2)
    mask: jax.Array,      # (L, K) bool visibility
    pose_free: jax.Array, # (K,) bool — False = gauge-fixed pose
    point_valid: jax.Array | None = None,  # (L,) bool
    max_iters: int = 10,
    huber: float = 5.0,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.5,
) -> dict:
    """Levenberg-Marquardt BA with accept/reject damping control, fixed
    iteration count (jit-safe: rejected steps are no-ops via jnp.where).

    Returns dict with R, t, X, cost, initial_cost, lam.
    """
    if point_valid is not None:
        mask = mask & point_valid[:, None]
    return _bundle_adjust_core(
        cam, R, t, X, z, mask, pose_free,
        max_iters=max_iters, huber=huber, lam0=lam0,
        lam_up=lam_up, lam_down=lam_down, preduce=lambda x: x,
    )


def _bundle_adjust_core(
    cam, R, t, X, z, mask, pose_free,
    max_iters, huber, lam0, lam_up, lam_down, preduce,
) -> dict:
    """LM scan shared by the single-device and shard_map (distributed)
    paths.  With `preduce = lax.psum(., landmark_axis)`, X/z/mask are the
    LOCAL landmark shard: pose-side reductions cross the mesh, landmark
    updates stay local, and every device runs the identical replicated
    (6K x 6K) solve — the TP-analog map-sharding of SURVEY §2d."""

    # One-time layout change to landmarks-last (L-minor) — see the _ll
    # kernels above.  z/mask are loop constants, transposed once here; only
    # X round-trips (3, L) <-> (L, 3), which is cheap.
    zt = jnp.transpose(z, (1, 2, 0))                    # (K, 2, L)
    maskt = jnp.transpose(mask, (1, 0))                 # (K, L)

    def blocks(R_, t_, Xt_):
        U, gc, V, gp, W, cost, num_ok = ba_normal_blocks_ll(
            cam, R_, t_, Xt_, zt, maskt, huber
        )
        return (preduce(U), preduce(gc), V, gp, W,
                preduce(cost), preduce(num_ok))

    def lm_step(state: BAState, _):
        U, gc, V, gp, W, cost, num_ok = blocks(state.R, state.t, state.X)
        S, b, Vinv = schur_reduce_ll(U, gc, V, gp, W, state.lam, pose_free,
                                     preduce=preduce)
        K = U.shape[0]
        # Cholesky with fallback: if S is not PD (should not happen with
        # damping), the solve yields nan and the step is rejected below.
        L_chol = jnp.linalg.cholesky(S + 1e-8 * jnp.eye(6 * K, dtype=S.dtype))
        dc = jax.scipy.linalg.cho_solve((L_chol, True), b).reshape(K, 6)
        dp = back_substitute_ll(Vinv, W, gp, dc)

        dR, dt = se3_exp(dc)                            # (K, 3, 3), (K, 3)
        R_new, t_new = se3_compose(dR, dt, state.R, state.t)
        X_new = state.X + dp

        _, _, _, _, _, cost_new, num_ok_new = blocks(R_new, t_new, X_new)
        # A masked cost can only be compared when the active-residual sets
        # are comparable: a divergent step that pushes points behind the
        # cameras empties the mask and scores a spurious cost of 0.
        # Shedding guard: a per-step slack of 2 residuals (a legitimate step
        # routinely moves one marginal point out of a frustum as poses
        # refine; zero slack made that terminal — damping could only ratchet
        # up) bounded by a hard 95%-of-initial floor so the slack cannot
        # compound across iterations into the ~2/3 mass-shedding collapse
        # the guard exists to prevent.
        shed_floor = jnp.maximum(
            state.num_ok - 2,
            (0.95 * num_ok0.astype(jnp.float32)).astype(jnp.int32),
        )
        accept = (
            jnp.isfinite(cost_new)
            & (cost_new < cost)
            & (num_ok_new >= shed_floor)
        )
        accept &= preduce(
            jnp.all(jnp.isfinite(X_new)).astype(jnp.int32)
        ) == _preduce_count(preduce)
        accept &= jnp.all(jnp.isfinite(t_new))
        state_new = BAState(
            R=jnp.where(accept, R_new, state.R),
            t=jnp.where(accept, t_new, state.t),
            X=jnp.where(accept, X_new, state.X),
            lam=jnp.clip(
                jnp.where(accept, state.lam * lam_down, state.lam * lam_up),
                1e-9,
                1e6,
            ),
            cost=jnp.where(accept, cost_new, cost),
            num_ok=jnp.where(accept, num_ok_new, state.num_ok),
        )
        return state_new, cost

    Xt0 = jnp.transpose(X, (1, 0))                      # (3, L) carried layout
    _, _, _, _, _, cost0, num_ok0 = blocks(R, t, Xt0)
    init = BAState(R=R, t=t, X=Xt0, lam=jnp.asarray(lam0, X.dtype), cost=cost0,
                   num_ok=num_ok0)
    final, costs = jax.lax.scan(lm_step, init, None, length=max_iters)
    return {
        "R": final.R,
        "t": final.t,
        "X": jnp.transpose(final.X, (1, 0)),
        "cost": final.cost,
        "initial_cost": cost0,
        "lam": final.lam,
    }


def _preduce_count(preduce) -> jax.Array:
    """Number of participants in `preduce` (1 for identity, axis size for
    psum) — psum of ones."""
    return preduce(jnp.asarray(1, jnp.int32))
