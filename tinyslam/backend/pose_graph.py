"""Pose-graph optimization (loop-closure back-end, BASELINE config 5).

Nodes are keyframe poses (world->camera); edges carry measured relative
transforms T_ij (T_j = T_ij o T_i) from odometry and loop closures, with a
validity mask so the problem is fixed-shape.  Residual per edge:

    r_e = log( T_ij_meas^-1 o T_j o T_i^-1 )  in se(3)

Gauss-Newton with jacfwd edge Jacobians, block scatter-add assembly of the
dense (6N x 6N) system, Cholesky solve, node 0 gauge-fixed.  N <= ~256
keeps the dense solve cheap as one matrix factorization; larger graphs shard edges and psum
(the trajectory-growth analog of sequence parallelism, SURVEY §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinyslam.geometry.se3 import (
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
)
from tinyslam.geometry.sim3 import (
    sim3_compose,
    sim3_exp,
    sim3_inverse,
    sim3_log,
)


def edge_residual(Ri, ti, Rj, tj, Rm, tm):
    """r = log(Tm^-1 o T_j o T_i^-1) for one edge."""
    Rii, tii = se3_inverse(Ri, ti)
    Rrel, trel = se3_compose(Rj, tj, Rii, tii)
    Rmi, tmi = se3_inverse(Rm, tm)
    Re, te = se3_compose(Rmi, tmi, Rrel, trel)
    return se3_log(Re, te)


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    R: jax.Array,          # (N, 3, 3) node rotations (world->camera)
    t: jax.Array,          # (N, 3)
    edge_i: jax.Array,     # (E,) int32 source node
    edge_j: jax.Array,     # (E,) int32 target node
    edge_R: jax.Array,     # (E, 3, 3) measured relative rotation
    edge_t: jax.Array,     # (E, 3)
    edge_valid: jax.Array, # (E,) bool
    edge_weight: jax.Array | None = None,  # (E,) relative information scale
    node_valid: jax.Array | None = None,   # (N,) bool
    iters: int = 20,
    damping: float = 1e-6,
) -> dict:
    return _pose_graph_core(
        R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
        edge_weight, node_valid, iters=iters, damping=damping,
    )


def _pose_graph_core(
    R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
    edge_weight=None, node_valid=None, iters: int = 20,
    damping: float = 1e-6, preduce=lambda x: x,
) -> dict:
    """Gauss-Newton pose-graph core.

    ``preduce`` hooks the normal-equation reduction: identity on one
    device; ``lax.psum`` over the edge-shard mesh axis in the distributed
    wrapper (parallel/dist_pose_graph.py) — each shard assembles H, g from
    its own edges and the solve runs replicated, so per-iteration comms is
    one (6N)^2 allreduce regardless of edge count.
    """
    n = R.shape[0]
    if edge_weight is None:
        edge_weight = jnp.ones_like(edge_valid, jnp.float32)
    if node_valid is None:
        node_valid = jnp.ones((n,), bool)
    w_e = edge_weight * edge_valid.astype(jnp.float32)
    # Gauge: node 0 fixed; invalid nodes also held (their edges are invalid).
    free = node_valid & (jnp.arange(n) != 0)

    def gn_step(carry, _):
        R_cur, t_cur = carry
        Ri, ti = R_cur[edge_i], t_cur[edge_i]
        Rj, tj = R_cur[edge_j], t_cur[edge_j]

        def res_fn(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
            dRi, dti = se3_exp(xi_i)
            dRj, dtj = se3_exp(xi_j)
            Ri2, ti2 = se3_compose(dRi, dti, Ri, ti)
            Rj2, tj2 = se3_compose(dRj, dtj, Rj, tj)
            return edge_residual(Ri2, ti2, Rj2, tj2, Rm, tm)

        zero = jnp.zeros(6, R.dtype)
        r = jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0, 0, 0, 0))(
            zero, zero, Ri, ti, Rj, tj, edge_R, edge_t
        )                                              # (E, 6)
        Ji = jax.vmap(
            lambda a, b, c, d, e, f: jax.jacfwd(res_fn, argnums=0)(
                zero, zero, a, b, c, d, e, f
            )
        )(Ri, ti, Rj, tj, edge_R, edge_t)              # (E, 6, 6)
        Jj = jax.vmap(
            lambda a, b, c, d, e, f: jax.jacfwd(res_fn, argnums=1)(
                zero, zero, a, b, c, d, e, f
            )
        )(Ri, ti, Rj, tj, edge_R, edge_t)              # (E, 6, 6)

        we = w_e[:, None, None]
        H = jnp.zeros((n, 6, n, 6), R.dtype)
        H = H.at[edge_i, :, edge_i, :].add(we * jnp.einsum("eab,eac->ebc", Ji, Ji))
        H = H.at[edge_j, :, edge_j, :].add(we * jnp.einsum("eab,eac->ebc", Jj, Jj))
        Hij = we * jnp.einsum("eab,eac->ebc", Ji, Jj)
        H = H.at[edge_i, :, edge_j, :].add(Hij)
        H = H.at[edge_j, :, edge_i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((n, 6), R.dtype)
        g = g.at[edge_i].add(-jnp.einsum("eab,ea->eb", Ji * we, r))
        g = g.at[edge_j].add(-jnp.einsum("eab,ea->eb", Jj * we, r))

        # Cross-shard reduction point (identity on a single device).
        H = preduce(H)
        g = preduce(g)

        fr = free.astype(R.dtype)
        H = H * fr[:, None, None, None] * fr[None, None, :, None]
        H = H.at[jnp.arange(n), :, jnp.arange(n), :].add(
            (1.0 - fr)[:, None, None] * jnp.eye(6, dtype=R.dtype)
        )
        g = g * fr[:, None]

        Hm = H.reshape(6 * n, 6 * n) + damping * jnp.eye(6 * n, dtype=R.dtype)
        Lc = jnp.linalg.cholesky(Hm)
        dx = jax.scipy.linalg.cho_solve((Lc, True), g.reshape(-1)).reshape(n, 6)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        dR, dt = se3_exp(dx)
        R_new, t_new = se3_compose(dR, dt, R_cur, t_cur)
        return (R_new, t_new), preduce(jnp.sum(w_e * jnp.sum(r * r, axis=-1)))

    (R_out, t_out), costs = jax.lax.scan(gn_step, (R, t), None, length=iters)
    return {"R": R_out, "t": t_out, "costs": costs}


# ---------------------------------------------------------------------------
# Sim(3) pose graph — monocular scale-drift-aware loop closure.
# ---------------------------------------------------------------------------


def sim3_edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log_sim3(Sm^-1 o S_j o S_i^-1) for one edge, (7,)."""
    Rii, tii, sii = sim3_inverse(Ri, ti, si)
    Rrel, trel, srel = sim3_compose(Rj, tj, sj, Rii, tii, sii)
    Rmi, tmi, smi = sim3_inverse(Rm, tm, sm)
    Re, te, se = sim3_compose(Rmi, tmi, smi, Rrel, trel, srel)
    return sim3_log(Re, te, se)


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph_sim3(
    R: jax.Array,          # (N, 3, 3) node rotations (world->camera)
    t: jax.Array,          # (N, 3)
    s: jax.Array,          # (N,) node scales (1.0 before any correction)
    edge_i: jax.Array,     # (E,) int32 source node
    edge_j: jax.Array,     # (E,) int32 target node
    edge_R: jax.Array,     # (E, 3, 3) measured relative rotation
    edge_t: jax.Array,     # (E, 3)
    edge_s: jax.Array,     # (E,) measured relative scale (odometry: 1.0)
    edge_valid: jax.Array, # (E,) bool
    edge_weight: jax.Array | None = None,
    node_valid: jax.Array | None = None,
    iters: int = 20,
    damping: float = 1e-6,
) -> dict:
    """Gauss-Newton over Sim(3) nodes (7 DoF each; the monocular scale
    gauge is fixed with node 0).  Identical structure to the SE(3) core:
    jacfwd edge Jacobians at xi = 0, dense (7N x 7N) scatter-add assembly,
    Cholesky, scan.  Scale drift injected by the loop edges' measured
    relative scales is distributed along the odometry chain — the SE(3)
    solver structurally cannot do this (its edges have no scale residual,
    so a 10% drift survives loop closure entirely as translation error).
    """
    n = R.shape[0]
    if edge_weight is None:
        edge_weight = jnp.ones_like(edge_valid, jnp.float32)
    if node_valid is None:
        node_valid = jnp.ones((n,), bool)
    w_e = edge_weight * edge_valid.astype(jnp.float32)
    free = node_valid & (jnp.arange(n) != 0)

    def gn_step(carry, _):
        R_cur, t_cur, s_cur = carry
        Ri, ti, si = R_cur[edge_i], t_cur[edge_i], s_cur[edge_i]
        Rj, tj, sj = R_cur[edge_j], t_cur[edge_j], s_cur[edge_j]

        def res_fn(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
            dRi, dti, dsi = sim3_exp(xi_i)
            dRj, dtj, dsj = sim3_exp(xi_j)
            Ri2, ti2, si2 = sim3_compose(dRi, dti, dsi, Ri, ti, si)
            Rj2, tj2, sj2 = sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
            return sim3_edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)

        zero = jnp.zeros(7, R.dtype)
        r = jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))(
            zero, zero, Ri, ti, si, Rj, tj, sj, edge_R, edge_t, edge_s
        )                                              # (E, 7)
        Ji = jax.vmap(
            lambda a, b, c, d, e, f, g, h, k: jax.jacfwd(res_fn, argnums=0)(
                zero, zero, a, b, c, d, e, f, g, h, k
            )
        )(Ri, ti, si, Rj, tj, sj, edge_R, edge_t, edge_s)   # (E, 7, 7)
        Jj = jax.vmap(
            lambda a, b, c, d, e, f, g, h, k: jax.jacfwd(res_fn, argnums=1)(
                zero, zero, a, b, c, d, e, f, g, h, k
            )
        )(Ri, ti, si, Rj, tj, sj, edge_R, edge_t, edge_s)   # (E, 7, 7)

        we = w_e[:, None, None]
        H = jnp.zeros((n, 7, n, 7), R.dtype)
        H = H.at[edge_i, :, edge_i, :].add(we * jnp.einsum("eab,eac->ebc", Ji, Ji))
        H = H.at[edge_j, :, edge_j, :].add(we * jnp.einsum("eab,eac->ebc", Jj, Jj))
        Hij = we * jnp.einsum("eab,eac->ebc", Ji, Jj)
        H = H.at[edge_i, :, edge_j, :].add(Hij)
        H = H.at[edge_j, :, edge_i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((n, 7), R.dtype)
        g = g.at[edge_i].add(-jnp.einsum("eab,ea->eb", Ji * we, r))
        g = g.at[edge_j].add(-jnp.einsum("eab,ea->eb", Jj * we, r))

        fr = free.astype(R.dtype)
        H = H * fr[:, None, None, None] * fr[None, None, :, None]
        H = H.at[jnp.arange(n), :, jnp.arange(n), :].add(
            (1.0 - fr)[:, None, None] * jnp.eye(7, dtype=R.dtype)
        )
        g = g * fr[:, None]

        Hm = H.reshape(7 * n, 7 * n) + damping * jnp.eye(7 * n, dtype=R.dtype)
        Lc = jnp.linalg.cholesky(Hm)
        dx = jax.scipy.linalg.cho_solve((Lc, True), g.reshape(-1)).reshape(n, 7)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        dR, dt, ds = sim3_exp(dx)
        R_new, t_new, s_new = sim3_compose(dR, dt, ds, R_cur, t_cur, s_cur)
        return (R_new, t_new, s_new), jnp.sum(w_e * jnp.sum(r * r, axis=-1))

    (R_out, t_out, s_out), costs = jax.lax.scan(
        gn_step, (R, t, s), None, length=iters)
    return {"R": R_out, "t": t_out, "s": s_out, "costs": costs}
