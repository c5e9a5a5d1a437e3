"""Reprojection residuals and analytic Jacobians for bundle adjustment.

Dense over the (landmark, keyframe) grid with a visibility mask — the
fixed-shape formulation of a sparse BA problem (SURVEY §7 hard part 2):
invisible observations carry zero weight instead of being absent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinyslam.geometry.camera import PinholeCamera
from tinyslam.geometry.se3 import so3_hat


def reprojection_residuals(
    cam: PinholeCamera,
    R: jax.Array,       # (K, 3, 3) world->camera
    t: jax.Array,       # (K, 3)
    X: jax.Array,       # (L, 3) world points
    z: jax.Array,       # (L, K, 2) pixel observations
    mask: jax.Array,    # (L, K) visibility
):
    """Returns r (L,K,2), J_pose (L,K,2,6), J_point (L,K,2,3), ok (L,K).

    Pose Jacobian is wrt a LEFT increment T_k <- exp(xi) T_k; point Jacobian
    wrt X_l directly.  `ok` excludes points behind a camera.
    """
    pc = jnp.einsum("kij,lj->lki", R, X) + t[None]     # (L, K, 3)
    zc = pc[..., 2]
    ok = mask & (zc > 1e-4)
    zs = jnp.where(ok, zc, 1.0)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    r = jnp.stack([u, v], axis=-1) - z                 # (L, K, 2)
    r = jnp.where(ok[..., None], r, 0.0)

    inv_z = 1.0 / zs
    x_z = pc[..., 0] * inv_z
    y_z = pc[..., 1] * inv_z
    zero = jnp.zeros_like(zc)
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * inv_z, zero, -cam.fx * x_z * inv_z], axis=-1),
            jnp.stack([zero, cam.fy * inv_z, -cam.fy * y_z * inv_z], axis=-1),
        ],
        axis=-2,
    )                                                  # (L, K, 2, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (*pc.shape[:-1], 3, 3))
    J_pc_pose = jnp.concatenate([eye, -so3_hat(pc)], axis=-1)   # (L, K, 3, 6)
    J_pose = J_proj @ J_pc_pose                        # (L, K, 2, 6)
    # d pc / d X = R_k
    J_point = jnp.einsum("lkab,kbc->lkac", J_proj, R)  # (L, K, 2, 3)
    okf = ok[..., None, None].astype(pc.dtype)
    return r, J_pose * okf, J_point * okf, ok


def reprojection_residuals_ll(
    cam: PinholeCamera,
    R: jax.Array,       # (K, 3, 3) world->camera
    t: jax.Array,       # (K, 3)
    Xt: jax.Array,      # (3, L) world points, landmarks-LAST
    zt: jax.Array,      # (K, 2, L) pixel observations
    maskt: jax.Array,   # (K, L) visibility
):
    """Landmarks-last layout of reprojection_residuals.

    Identical math; the L axis is MINOR in every array so it is the wide,
    contiguous dimension.  The (L, K, 2, 6) layout above puts each tiny
    trailing (2, 6) block in the minor dimensions — padded many times over —
    which makes the whole LM iteration memory-bound on padding traffic; this
    layout keeps every op a dense (…, L) vector op / L-minor matmul.

    Returns r (K,2,L), J_pose (K,2,6,L), J_point (K,2,3,L), ok (K,L).
    """
    dtype = Xt.dtype
    pc = jnp.einsum("kij,jl->kil", R, Xt) + t[..., None]   # (K, 3, L)
    xc, yc, zc = pc[:, 0], pc[:, 1], pc[:, 2]              # (K, L)
    ok = maskt & (zc > 1e-4)
    zs = jnp.where(ok, zc, 1.0)
    inv_z = 1.0 / zs
    u = cam.fx * xc * inv_z + cam.cx
    v = cam.fy * yc * inv_z + cam.cy
    r = jnp.stack([u, v], axis=1) - zt                     # (K, 2, L)
    r = jnp.where(ok[:, None, :], r, 0.0)

    x_z = xc * inv_z
    y_z = yc * inv_z
    zero = jnp.zeros_like(zc)
    # J_proj (K, 2, 3, L): d(u,v)/d pc.
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * inv_z, zero, -cam.fx * x_z * inv_z], axis=1),
            jnp.stack([zero, cam.fy * inv_z, -cam.fy * y_z * inv_z], axis=1),
        ],
        axis=1,
    )
    # J_pc_pose (K, 3, 6, L) = [I | -hat(pc)], built per column to stay
    # elementwise over L (a generic einsum would transpose L off the lanes).
    one = jnp.ones_like(zc)
    Jpp = [
        [one, zero, zero, zero, zc, -yc],
        [zero, one, zero, -zc, zero, xc],
        [zero, zero, one, yc, -xc, zero],
    ]
    okf = ok[:, None, :].astype(dtype)
    # J_pose (K, 2, 6, L) = sum_c J_proj[:, :, c] * Jpp[c]
    J_pose = jnp.stack(
        [
            sum(J_proj[:, :, c] * Jpp[c][a][:, None, :] for c in range(3))
            for a in range(6)
        ],
        axis=2,
    ) * okf[:, :, None, :]
    # J_point (K, 2, 3, L) = sum_c J_proj[:, :, c] * R[:, c, a]
    J_point = jnp.stack(
        [
            sum(J_proj[:, :, c] * R[:, c, a][:, None, None] for c in range(3))
            for a in range(3)
        ],
        axis=2,
    ) * okf[:, :, None, :]
    return r, J_pose, J_point, ok
