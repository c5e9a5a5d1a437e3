"""Sim(3) Lie-group operations — scale-aware similarity transforms.

Monocular SLAM has a 7th gauge freedom: scale.  Odometry drift therefore
has a scale component that SE(3) pose-graph edges cannot absorb (the round-3
verdict's dominant error on the mh01-like run); the canonical fix (Strasdat
et al., "Scale Drift-Aware Large Scale Monocular SLAM", RSS 2010 — the
structure ORB-SLAM's loop closing adopts) is to close loops over Sim(3).

A similarity S = (R, t, s) acts on points as  X -> s * R @ X + t.  Tangent
vectors xi are (..., 7) ordered [rho (trans 3), phi (rot 3), sigma (log
scale 1)].  Composition/inverse follow from the action; exp uses the
W-matrix generalization of SE(3)'s left Jacobian; log solves the 3x3 W
system for rho.

Same conventions as geometry/se3.py: batch-friendly, jit-safe, small-value
branches via jnp.where with safe denominators (differentiable at xi = 0,
which is where the pose-graph Jacobians are taken).

The reference has no pose graph at all (loop closure is unchecked roadmap,
reference README.md:53-57).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinyslam.geometry.se3 import so3_exp, so3_hat, so3_log

_EPS = 1e-8


def _sim3_W(phi: jax.Array, sigma: jax.Array) -> jax.Array:
    """W(phi, sigma) with t = W @ rho in sim3_exp.

    Region-wise closed forms (Sophus sim3 calc_W), selected branchlessly:
      theta, sigma both finite:  A, B, C from the full trigonometric form;
      small theta:               sigma-only forms;
      small sigma:               the SE(3) left Jacobian (C -> 1);
      both small:                Taylor constants (exact value AND first
                                 derivative where it matters: at xi = 0 the
                                 phi/sigma derivatives of W are multiplied
                                 by rho = 0 in the pose-graph Jacobians).
    """
    theta2 = jnp.sum(phi * phi, axis=-1)
    small_t = theta2 < 1e-10
    small_s = jnp.abs(sigma) < 1e-5
    theta = jnp.sqrt(jnp.where(small_t, 1.0, theta2))
    sig = jnp.where(small_s, 1.0, sigma)
    s = jnp.exp(sigma)

    Om = so3_hat(phi)
    Om2 = Om @ Om
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Om.shape)

    # big sigma, big theta
    a_ = s * jnp.sin(theta)
    b_ = s * jnp.cos(theta)
    c_ = theta2 + sigma * sigma
    c_safe = jnp.where(small_t & small_s, 1.0, c_)
    C_big = (s - 1.0) / sig
    A_bb = (a_ * sigma + (1.0 - b_) * theta) / (theta * c_safe)
    B_bb = (C_big - ((b_ - 1.0) * sigma + a_ * theta) / c_safe) / theta2

    # big sigma, small theta
    A_bs = ((sigma - 1.0) * s + 1.0) / (sig * sig)
    B_bs = (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / (sig * sig * sig)

    # small sigma, big theta (SE(3) left Jacobian coefficients)
    A_sb = (1.0 - jnp.cos(theta)) / theta2
    B_sb = (theta - jnp.sin(theta)) / (theta2 * theta)

    # small sigma, small theta (Taylor)
    A_ss = jnp.full_like(sigma, 0.5)
    B_ss = jnp.full_like(sigma, 1.0 / 6.0)

    A = jnp.where(small_s, jnp.where(small_t, A_ss, A_sb),
                  jnp.where(small_t, A_bs, A_bb))
    B = jnp.where(small_s, jnp.where(small_t, B_ss, B_sb),
                  jnp.where(small_t, B_bs, B_bb))
    C = jnp.where(small_s, 1.0 + 0.5 * sigma, C_big)

    return (C[..., None, None] * I + A[..., None, None] * Om
            + B[..., None, None] * Om2)


def sim3_identity(batch: tuple[int, ...] = (), dtype=jnp.float32):
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch, 3, 3))
    t = jnp.zeros((*batch, 3), dtype=dtype)
    s = jnp.ones(batch, dtype=dtype)
    return R, t, s


def sim3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(..., 7) [rho, phi, sigma] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    W = _sim3_W(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return R, t, jnp.exp(sigma)


def sim3_log(R: jax.Array, t: jax.Array, s: jax.Array) -> jax.Array:
    """(R, t, s) -> (..., 7) [rho, phi, sigma]."""
    phi = so3_log(R)
    sigma = jnp.log(s)
    W = _sim3_W(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(a) o (b): apply b first, then a.  X -> sa Ra (sb Rb X + tb) + ta."""
    R = Ra @ Rb
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return R, t, sa * sb


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_apply(R, t, s, x) -> jax.Array:
    """Transform points x (..., 3):  s R x + t."""
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, x) + t


def sim3_from_se3(R, t):
    """Lift an SE(3) pose to Sim(3) with unit scale."""
    return R, t, jnp.ones(R.shape[:-2], R.dtype)


def sim3_to_se3(R, t, s):
    """Project a Sim(3) camera pose back to SE(3).

    A world->camera similarity  x_cam = s R X + t  describes the same
    camera center as the SE(3) pose (R, t / s) — dividing out s rescales
    camera-frame coordinates, which a projective camera cannot observe.
    (ORB-SLAM's loop closing applies corrected Sim3 poses the same way.)
    """
    return R, t / s[..., None]
