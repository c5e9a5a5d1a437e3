"""PnP pose tracking: robust Gauss-Newton on SE(3) from 3D-2D matches.

The per-frame tracker (BASELINE config 3): given map points and their pixel
observations in the current frame, refine the camera pose.  Fixed iteration
count, Huber-weighted, analytic 2x6 Jacobians — one fused batch of einsums
per iteration, no per-point control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.se3 import se3_apply, se3_compose, se3_exp, so3_hat


def _residual_jacobian(cam: PinholeCamera, R, t, X, uv):
    """Residuals r = project(R X + t) - uv and Jacobians wrt a LEFT update
    T <- exp(xi) T.  Returns r (N, 2), J (N, 2, 6), front (N,) mask."""
    pc = se3_apply(R, t, X)                            # (N, 3)
    z = pc[..., 2]
    front = z > 1e-4
    zs = jnp.where(front, z, 1.0)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    r = jnp.stack([u, v], axis=-1) - uv                # (N, 2)

    inv_z = 1.0 / zs
    x_z = pc[..., 0] * inv_z
    y_z = pc[..., 1] * inv_z
    zero = jnp.zeros_like(z)
    # d(u,v)/d pc
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * inv_z, zero, -cam.fx * x_z * inv_z], axis=-1),
            jnp.stack([zero, cam.fy * inv_z, -cam.fy * y_z * inv_z], axis=-1),
        ],
        axis=-2,
    )                                                  # (N, 2, 3)
    # d pc / d xi for left update: [I | -[pc]_x]
    J_pc = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (*pc.shape[:-1], 3, 3)),
            -so3_hat(pc),
        ],
        axis=-1,
    )                                                  # (N, 3, 6)
    J = J_proj @ J_pc                                  # (N, 2, 6)
    return r, J, front


@functools.partial(jax.jit, static_argnames=("iters", "final_iters"))
def pnp_refine(
    cam: PinholeCamera,
    X: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
    R0: jax.Array,
    t0: jax.Array,
    iters: int = 8,
    huber_px: float = 4.0,
    damping: float = 1e-4,
    inlier_px: float = 4.0,
    final_iters: int = 4,
) -> dict[str, jax.Array]:
    """Two-stage Levenberg-damped Gauss-Newton PnP.

    Stage 1: `iters` Huber-weighted iterations over all observations
    (robust to outliers).  Stage 2: hard-reject residuals above `inlier_px`
    and run `final_iters` clean iterations on the survivors — Huber only
    downweights outliers, and at 20-30%% contamination the residual bias is
    measurable; the clean pass removes it.

    Args:
      cam: pinhole intrinsics.
      X: (N, 3) world points; uv: (N, 2) pixel observations; valid: (N,).
      R0, t0: initial world->camera pose.

    Returns dict with R, t, inliers (N,), rmse ().
    """

    def make_step(mask):
        def gn_step(carry, _):
            R, t = carry
            r, J, front = _residual_jacobian(cam, R, t, X, uv)
            ok = mask & front
            err = jnp.linalg.norm(r, axis=-1)
            # Huber IRLS weight.
            w_rob = jnp.where(err > huber_px, huber_px / jnp.maximum(err, 1e-9), 1.0)
            w = w_rob * ok.astype(jnp.float32)         # (N,)
            Jw = J * w[:, None, None]
            H = jnp.einsum("nik,nil->kl", Jw, J)       # (6, 6)
            g = jnp.einsum("nik,ni->k", Jw, r)         # (6,)
            H = H + damping * jnp.eye(6, dtype=H.dtype) * (1.0 + jnp.diag(H))
            delta = -jnp.linalg.solve(H, g)
            dR, dt = se3_exp(delta)
            return se3_compose(dR, dt, R, t), None
        return gn_step

    (R, t), _ = jax.lax.scan(make_step(valid), (R0, t0), None, length=iters)

    # Stage 2: hard outlier rejection, then clean iterations.
    r, _, front = _residual_jacobian(cam, R, t, X, uv)
    err = jnp.linalg.norm(r, axis=-1)
    keep = valid & front & (err < inlier_px)
    # Guard: only shrink the active set if enough survivors remain.
    keep = jnp.where(jnp.sum(keep.astype(jnp.int32)) >= 6, keep, valid)
    (R, t), _ = jax.lax.scan(make_step(keep), (R, t), None, length=final_iters)

    r, _, front = _residual_jacobian(cam, R, t, X, uv)
    err = jnp.linalg.norm(r, axis=-1)
    inliers = valid & front & (err < inlier_px)
    n_in = jnp.maximum(jnp.sum(inliers.astype(jnp.float32)), 1.0)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inliers, err * err, 0.0)) / n_in)
    return {"R": R, "t": t, "inliers": inliers, "rmse": rmse,
            "num_inliers": jnp.sum(inliers.astype(jnp.int32))}


def _dlt_pose(cam: PinholeCamera, X: jax.Array, uv: jax.Array,
              w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Weighted DLT absolute pose from >= 6 3D-2D matches.

    Builds the 2n x 12 homogeneous system for P = [R|t] in NORMALIZED image
    coords, solves for its null vector via eigh of the 12x12 normal matrix,
    then projects the 3x3 block onto SO(3) with a Newton polar iteration and
    fixes scale/chirality by the depth sign.  (No SVD anywhere: its XLA
    lowering is slow to compile per shape — geometry/linalg.py.)

    The 3D points are Hartley-normalized first (weighted centroid at the
    origin, RMS radius sqrt(3)); the normal matrix squares the condition
    number, and without normalization minimal 6-point samples are so
    ill-conditioned in f32 that even all-inlier samples vote near zero.

    Args: X (N, 3), uv (N, 2) pixels, w (N,) weights (0 disables a row).
    Returns (R, t).  Degenerate inputs yield garbage poses — callers score
    hypotheses by inlier count, so bad samples lose the vote (RANSAC).
    """
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    n = X.shape[0]

    # Hartley normalization of the world points (weighted).
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    c = jnp.sum(X * w[:, None], axis=0) / wsum                     # centroid
    r = jnp.sqrt(jnp.sum(jnp.sum((X - c) ** 2, axis=1) * w) / wsum)
    s = jnp.sqrt(3.0) / jnp.maximum(r, 1e-9)
    Xn = (X - c) * s

    zeros = jnp.zeros((n, 4), X.dtype)
    Xh = jnp.concatenate([Xn, jnp.ones((n, 1), X.dtype)], axis=1)  # (N, 4)
    rows_u = jnp.concatenate([Xh, zeros, -x[:, None] * Xh], axis=1)
    rows_v = jnp.concatenate([zeros, Xh, -y[:, None] * Xh], axis=1)
    A = jnp.concatenate([rows_u * w[:, None], rows_v * w[:, None]], axis=0)
    from tinyslam.geometry.linalg import null_vector, polar_rotation3

    p = null_vector(A).reshape(3, 4)
    Rp, tp = p[:, :3], p[:, 3]
    # Nearest rotation via the polar factor; det(U) = sign(lam) for
    # Rp = lam * R_true, so multiplying by det both fixes improper factors
    # and absorbs the +-p null-vector sign ambiguity.
    U = polar_rotation3(Rp)
    detR = jnp.linalg.det(U)
    R = U * detR
    # R^T Rp = lam I  =>  lam = trace(R^T Rp) / 3 (signed); t = tp / lam.
    lam = jnp.trace(R.T @ Rp) / 3.0
    lam = jnp.where(jnp.abs(lam) > 1e-12, lam, 1e-12)
    tn = tp / lam
    # Undo the normalization: R(s(X - c)) + tn projects like R X + t with
    # t = tn/s - R c (projection is invariant to the positive factor s).
    t = tn / s - R @ c
    return R, t


@functools.partial(jax.jit, static_argnames=("num_hypotheses", "sample_size",
                                              "refine_iters"))
def pnp_ransac(
    cam: PinholeCamera,
    X: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 256,
    sample_size: int = 6,
    inlier_px: float = 6.0,
    refine_iters: int = 8,
    R_prior: jax.Array | None = None,
    t_prior: jax.Array | None = None,
) -> dict[str, jax.Array]:
    """Absolute-pose LO-RANSAC: batched DLT hypotheses, inlier vote, then
    local optimization restricted to the winning hypothesis's inliers.

    The relocalization initializer (no pose prior needed — pnp_refine alone
    is a LOCAL method and cannot recover from a stale pose).  All hypotheses
    are solved in one vmap — RANSAC as a batch, not a loop (SURVEY §7:
    batched hypotheses are the fixed-shape form of RANSAC).

    ``R_prior``/``t_prior`` (optional): a stale-but-plausible pose (e.g. the
    pre-crash pose after a checkpoint restore) appended to the hypothesis
    pool; it wins the vote iff it still explains more matches than any
    sampled hypothesis.

    Design notes (both matter at realistic reloc inlier rates of ~40-50%):
    - ``sample_size=6`` is the DLT minimum (11 DoF / 2 eqs per point); the
      probability of an all-inlier sample is p^S, so every extra sample
      point beyond 6 costs ~2x hypotheses at p=0.5.
    - The polish refines on the BEST HYPOTHESIS'S voted inliers, then
      expands once (re-collect inliers under the refined pose, re-refine).
      Refining on *all* matches — the naive choice — diverges even from the
      true pose when outliers are the majority: Huber only bounds each
      outlier's influence, it does not zero it.

    Returns dict with R, t, inliers (N,), num_inliers, rmse.
    """
    # Sample indices proportional to validity (invalid entries pushed out).
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(
        key, logits[None, :], axis=-1,
        shape=(num_hypotheses, sample_size))           # (H, S)

    def hyp(sample_idx):
        # Gather the minimal sample: the DLT then solves a (2S, 12) system
        # instead of weighting all N rows — 512 hypotheses are one vmapped
        # small SVD, not 512 full-size ones.
        Xs = X[sample_idx]
        uvs = uv[sample_idx]
        return _dlt_pose(cam, Xs, uvs, jnp.ones((sample_size,), X.dtype))

    Rs, ts = jax.vmap(hyp)(idx)                        # (H, 3, 3), (H, 3)
    if R_prior is not None:
        Rs = jnp.concatenate([Rs, R_prior[None]], axis=0)
        ts = jnp.concatenate([ts, t_prior[None]], axis=0)

    def inlier_mask(R, t):
        pc = X @ R.T + t
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        err = jnp.linalg.norm(jnp.stack([u, v], -1) - uv, axis=-1)
        return valid & (pc[:, 2] > 1e-4) & (err < inlier_px)

    votes = jax.vmap(
        lambda R, t: jnp.sum(inlier_mask(R, t).astype(jnp.int32)))(Rs, ts)

    # Locally optimize the TOP-K hypotheses, not just the winner: repetitive
    # structure produces wrong consensus modes whose raw vote can beat the
    # true pose's; after refinement the true mode's support wins.  K refines
    # are one vmapped batch — width instead of sequential depth.
    top_k = 16
    _, top = jax.lax.top_k(votes, top_k)

    def polish(h):
        R0, t0 = Rs[h], ts[h]
        m0 = inlier_mask(R0, t0)
        m0 = jnp.where(jnp.sum(m0.astype(jnp.int32)) >= 6, m0, valid)
        o = pnp_refine(cam, X, uv, m0, R0, t0,
                       iters=refine_iters, inlier_px=inlier_px)
        # One expansion round: matches that became consistent under the
        # refined pose join the set; refine again on the expanded consensus.
        m1 = inlier_mask(o["R"], o["t"])
        m1 = jnp.where(jnp.sum(m1.astype(jnp.int32)) >= 6, m1, m0)
        o = pnp_refine(cam, X, uv, m1, o["R"], o["t"],
                       iters=4, inlier_px=inlier_px)
        final = inlier_mask(o["R"], o["t"])
        return o["R"], o["t"], jnp.sum(final.astype(jnp.int32))

    Rk, tk, nk = jax.vmap(polish)(top)
    win = jnp.argmax(nk)
    R_best, t_best = Rk[win], tk[win]

    # Report inliers/rmse against the FULL match set, not the consensus
    # subset, so callers' track-quality gates see the real support.
    final = inlier_mask(R_best, t_best)
    pc = X @ R_best.T + t_best
    z = jnp.maximum(pc[:, 2], 1e-6)
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    err = jnp.linalg.norm(jnp.stack([u, v], -1) - uv, axis=-1)
    n_in = jnp.maximum(jnp.sum(final.astype(jnp.float32)), 1.0)
    return {
        "R": R_best,
        "t": t_best,
        "inliers": final,
        "num_inliers": jnp.sum(final.astype(jnp.int32)),
        "rmse": jnp.sqrt(jnp.sum(jnp.where(final, err * err, 0.0)) / n_in),
        "hypothesis_inliers": votes[top[win]],
    }
