"""Distributed pose-graph optimization: edges sharded over the mesh.

The trajectory-growth analog of sequence parallelism (SURVEY §5
"long-context"): as the pose graph grows, edge count E (odometry + loop
closures) dominates the per-iteration Jacobian/assembly work, while the
node state (N poses) stays comparatively small.  So we shard the EDGE set
over a mesh axis and keep the node state replicated:

- each device evaluates residuals + Jacobians for its E/D edge shard and
  scatter-adds its local (6N x 6N) normal-equation block;
- one ``lax.psum`` over the axis yields the global H, g on every device;
- the Cholesky solve and the node update run replicated (deterministic, so
  no broadcast needed).

Per-GN-iteration communication is a single (6N)^2 + 6N allreduce,
independent of E — the same O(state), not O(data), comms shape as the
landmark-sharded BA (parallel/dist_ba.py).

The reference has no distributed layer of any kind (SURVEY §2d: absence
verified over the whole repo); this component exists to satisfy the
BASELINE multi-host SLAM config.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tinyslam.backend.pose_graph import _pose_graph_core


def optimize_pose_graph_sharded(
    mesh: Mesh,
    R: jax.Array,          # (N, 3, 3) replicated
    t: jax.Array,          # (N, 3)
    edge_i: jax.Array,     # (E,) int32 — E must divide by the axis size
    edge_j: jax.Array,     # (E,)
    edge_R: jax.Array,     # (E, 3, 3)
    edge_t: jax.Array,     # (E, 3)
    edge_valid: jax.Array, # (E,) bool
    edge_weight: jax.Array | None = None,
    node_valid: jax.Array | None = None,
    iters: int = 20,
    damping: float = 1e-6,
    axis: str = "landmark",
) -> dict:
    """Same contract and (up to reduction order) result as
    backend.pose_graph.optimize_pose_graph, with edges sharded over mesh
    axis ``axis``.  Pad the edge set (edge_valid=False) to a multiple of
    the axis size — invalid edges contribute zero."""
    if edge_weight is None:
        edge_weight = jnp.ones(edge_i.shape, jnp.float32)
    if node_valid is None:
        node_valid = jnp.ones((R.shape[0],), bool)

    fn = _sharded_pg_fn(mesh, iters, damping, axis)
    with mesh:
        return fn(R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                  edge_weight, node_valid)


@functools.lru_cache(maxsize=32)
def _sharded_pg_fn(mesh, iters, damping, axis):
    """Cached JITTED shard_map program (unjitted shard_map executes
    eagerly, and a fresh jax.jit per call recompiles — see dist_ba.py)."""
    repl = P()
    shard_E = P(axis)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(repl, repl, shard_E, shard_E, shard_E, shard_E, shard_E,
                  shard_E, repl),
        out_specs={"R": repl, "t": repl, "costs": repl},
        check_vma=False,
    )
    def run(R_, t_, ei_, ej_, eR_, et_, ev_, ew_, nv_):
        return _pose_graph_core(
            R_, t_, ei_, ej_, eR_, et_, ev_, ew_, nv_,
            iters=iters, damping=damping,
            preduce=lambda x: jax.lax.psum(x, axis),
        )

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Node-sharded pose graph — the trajectory-growth path (SURVEY §5).
#
# The edge-sharded solver above replicates the node state and the dense
# (6N)^2 solve on every device: exact, but the solve is the scaling blocker
# (N = 1024 -> a 151 MB H and a 0.77-TFLOP Cholesky, replicated).  Here the
# NODES are partitioned into contiguous blocks and each device solves an
# overlapping-Schwarz window around its own block:
#
#   - per GN sweep, each device assembles/solves only its (6W)^2 window,
#     W = B + 2*halo  (B = N/D) — memory and solve FLOPs drop by ~D^3;
#   - edges are bucketed to every shard whose WINDOW they touch (so each
#     window row carries its complete global gradient — the restricted-
#     additive-Schwarz consistency requirement); one shard is the edge's
#     PRIMARY owner so psum-reduced quantities count it exactly once;
#   - fine sweeps alternate red/black block parity (simultaneous updates of
#     adjacent overlapping windows overcorrect shared modes and oscillate);
#     after each half-sweep the boundary poses are halo-exchanged with the
#     ring neighbours via `lax.ppermute` (the CP-style neighbour exchange
#     of SURVEY §2d/§5); the full (tiny: 12 floats/node) pose state is
#     re-broadcast with `all_gather` only every `sync_every` sweeps;
#   - a COARSE phase (one rigid 6-DoF correction per block, psum-assembled,
#     (6D)^2 replicated solve) precedes each red/black pair: one-level
#     Schwarz moves loop-closure error one halo per sweep, so on
#     loop-dominated graphs it stalls — the coarse level carries that
#     error across the whole trajectory in one step (two-level Schwarz).
#
# The exact optimum is a fixed point (every window row has its true global
# gradient; all phases produce zero steps at g = 0); the parity test
# (tests/test_sharding.py) checks convergence to the replicated solver's
# optimum, not per-sweep equality.
# ---------------------------------------------------------------------------


def partition_edges_by_node(edge_i, edge_j, n_nodes: int, n_shards: int,
                            halo: int = 0):
    """Host-side edge bucketing: returns (sel, valid) of shape
    (n_shards, E_max) where sel indexes the original edge arrays.  A shard's
    bucket holds every edge touching its WINDOW [d*B - halo, (d+1)*B + halo)
    — not just its own block.  Restricted-additive-Schwarz correctness
    demands it: the window solve couples own rows with halo rows, so halo
    rows must carry their TRUE global gradient/Hessian entries, i.e. every
    edge incident to a halo node; otherwise the sharded fixed point is not
    the optimizer's (cross-shard edges are duplicated; each copy only ever
    updates its own side)."""
    import numpy as np

    B = n_nodes // n_shards
    halo = min(halo, B)
    W = min(B + 2 * halo, n_nodes)
    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    buckets: list[list[int]] = [[] for _ in range(n_shards)]
    for d in range(n_shards):
        # EXACTLY the device's clipped compute window [win0, win0 + W):
        # every solve row must carry its complete global gradient/Hessian.
        lo = int(np.clip(d * B - halo, 0, n_nodes - W))
        hi = lo + W
        touch = ((ei >= lo) & (ei < hi)) | ((ej >= lo) & (ej < hi))
        buckets[d] = list(np.nonzero(touch)[0])
    e_max = max(max(len(b) for b in buckets), 1)
    sel = np.zeros((n_shards, e_max), np.int32)
    valid = np.zeros((n_shards, e_max), bool)
    primary = np.zeros((n_shards, e_max), bool)
    owner = np.clip(ei // B, 0, n_shards - 1)   # canonical owner: shard of i
    for d, b in enumerate(buckets):
        sel[d, : len(b)] = b
        valid[d, : len(b)] = True
        primary[d, : len(b)] = owner[b] == d
    return sel, valid, primary


def optimize_pose_graph_node_sharded(
    mesh: Mesh,
    R: jax.Array,          # (N, 3, 3) — N must divide by the axis size
    t: jax.Array,          # (N, 3)
    edge_i: jax.Array,     # (E,) int32
    edge_j: jax.Array,     # (E,)
    edge_R: jax.Array,     # (E, 3, 3)
    edge_t: jax.Array,     # (E, 3)
    edge_valid: jax.Array, # (E,) bool
    edge_weight: jax.Array | None = None,
    iters: int = 40,
    halo: int = 8,
    sync_every: int = 4,
    damping: float = 1e-4,
    axis: str = "landmark",
) -> dict:
    """Node-sharded Gauss-Newton pose graph (overlapping Schwarz windows +
    ppermute halo exchange).  Same measurement convention as
    optimize_pose_graph; node 0 is the gauge."""
    n = R.shape[0]
    D = mesh.shape[axis]
    assert n % D == 0, (n, D)
    halo = min(halo, n // D)
    if edge_weight is None:
        edge_weight = jnp.ones(edge_i.shape, jnp.float32)

    sel, sel_valid, sel_prim = partition_edges_by_node(
        edge_i, edge_j, n, D, halo)
    ei_s = jnp.asarray(np.asarray(edge_i)[sel])          # (D, E_max)
    ej_s = jnp.asarray(np.asarray(edge_j)[sel])
    eR_s = jnp.asarray(np.asarray(edge_R)[sel])
    et_s = jnp.asarray(np.asarray(edge_t)[sel])
    ev_s = jnp.asarray(sel_valid) & jnp.asarray(np.asarray(edge_valid)[sel])
    ew_s = jnp.asarray(np.asarray(edge_weight)[sel])
    ep_s = jnp.asarray(sel_prim)

    fn = _node_sharded_fn(mesh, n, iters, halo, sync_every, damping, axis)
    with mesh:
        return fn(R, t, ei_s, ej_s, eR_s, et_s, ev_s, ew_s, ep_s)


@functools.lru_cache(maxsize=32)
def _node_sharded_fn(mesh, n, iters, halo, sync_every, damping, axis):
    """Cached JITTED shard_map program for the node-sharded solver
    (unjitted shard_map executes eagerly, and a fresh jax.jit per call
    recompiles — see dist_ba.py)."""
    from tinyslam.backend.pose_graph import edge_residual
    from tinyslam.geometry.se3 import se3_compose, se3_exp

    D = mesh.shape[axis]
    B = n // D
    W = min(B + 2 * halo, n)
    repl = P()
    shard_D = P(axis)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(repl, repl, shard_D, shard_D, shard_D, shard_D, shard_D,
                  shard_D, shard_D),
        out_specs={"R": repl, "t": repl, "costs": repl},
        check_vma=False,
    )
    def run(R0, t0, ei, ej, eR, et, ev, ew, ep):
        d = jax.lax.axis_index(axis)
        ei, ej = ei[0], ej[0]
        eR, et, ev, ew, ep = eR[0], et[0], ev[0], ew[0], ep[0]
        w_e = ew * ev.astype(jnp.float32)
        # Primary weights: every edge counted exactly once ACROSS shards —
        # the coarse psum-assembly and the reported cost must not double-
        # count the window-duplicated edges.
        w_p = w_e * ep.astype(jnp.float32)
        own0 = d * B                                    # own block start
        win0 = jnp.clip(own0 - halo, 0, n - W)          # window start

        def res_fn(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
            dRi, dti = se3_exp(xi_i)
            dRj, dtj = se3_exp(xi_j)
            Ri2, ti2 = se3_compose(dRi, dti, Ri, ti)
            Rj2, tj2 = se3_compose(dRj, dtj, Rj, tj)
            return edge_residual(Ri2, ti2, Rj2, tj2, Rm, tm)

        zero = jnp.zeros(6, R0.dtype)

        def jacobians(R_cur, t_cur):
            Ri, ti_ = R_cur[ei], t_cur[ei]
            Rj, tj = R_cur[ej], t_cur[ej]
            r = jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0, 0, 0, 0))(
                zero, zero, Ri, ti_, Rj, tj, eR, et)
            Ji = jax.vmap(lambda a, b, c, dd, e, f: jax.jacfwd(
                res_fn, argnums=0)(zero, zero, a, b, c, dd, e, f))(
                    Ri, ti_, Rj, tj, eR, et)
            Jj = jax.vmap(lambda a, b, c, dd, e, f: jax.jacfwd(
                res_fn, argnums=1)(zero, zero, a, b, c, dd, e, f))(
                    Ri, ti_, Rj, tj, eR, et)
            return r, Ji, Jj

        def residuals(R_cur, t_cur):
            return jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0, 0, 0, 0))(
                zero, zero, R_cur[ei], t_cur[ei], R_cur[ej], t_cur[ej],
                eR, et)

        bi = jnp.clip(ei // B, 0, D - 1)                 # coarse block ids
        bj = jnp.clip(ej // B, 0, D - 1)

        def coarse_phase(carry, it):
            """Two-level correction: one rigid 6-DoF update per node BLOCK,
            assembled by psum over primary edges and solved replicated
            ((6D)^2 — tiny).  This is what lets a loop-closure edge's error
            reach the far side of the trajectory in ONE sweep instead of
            diffusing one halo per sweep (the one-level Schwarz failure
            mode on loop-dominated graphs)."""
            R_cur, t_cur = carry
            r, Ji, Jj = jacobians(R_cur, t_cur)
            # Block-aggregated Jacobians; block 0 is the coarse gauge.
            in_i = (bi != 0)[:, None, None].astype(R0.dtype)
            in_j = (bj != 0)[:, None, None].astype(R0.dtype)
            Jci = Ji * in_i
            Jcj = Jj * in_j
            wp = w_p[:, None, None]
            Hc = jnp.zeros((D, 6, D, 6), R0.dtype)
            Hc = Hc.at[bi, :, bi, :].add(wp * jnp.einsum("eab,eac->ebc", Jci, Jci))
            Hc = Hc.at[bj, :, bj, :].add(wp * jnp.einsum("eab,eac->ebc", Jcj, Jcj))
            Hcij = wp * jnp.einsum("eab,eac->ebc", Jci, Jcj)
            Hc = Hc.at[bi, :, bj, :].add(Hcij)
            Hc = Hc.at[bj, :, bi, :].add(jnp.swapaxes(Hcij, -1, -2))
            gc = jnp.zeros((D, 6), R0.dtype)
            gc = gc.at[bi].add(-jnp.einsum("eab,ea->eb", Jci * wp, r))
            gc = gc.at[bj].add(-jnp.einsum("eab,ea->eb", Jcj * wp, r))
            Hc = jax.lax.psum(Hc, axis)
            gc = jax.lax.psum(gc, axis)
            diag = jnp.einsum("wawa->wa", Hc)
            pinned = jnp.sum(diag, axis=-1) < 1e-12
            Hc = Hc.at[jnp.arange(D), :, jnp.arange(D), :].add(
                pinned[:, None, None] * jnp.eye(6, dtype=R0.dtype))
            Hm = Hc.reshape(6 * D, 6 * D)
            Hm = Hm + damping * jnp.diag(jnp.maximum(jnp.diag(Hm), 1.0))
            Lc = jnp.linalg.cholesky(Hm)
            dxc = jax.scipy.linalg.cho_solve(
                (Lc, True), gc.reshape(-1)).reshape(D, 6)
            dxc = jnp.where(jnp.isfinite(dxc), dxc, 0.0)
            # Apply the block correction to every node — replicated math on
            # psum-reduced inputs, so all shards stay bit-identical.
            blk = jnp.arange(n) // B
            dR, dt = se3_exp(dxc[blk])
            R_new, t_new = se3_compose(dR, dt, R_cur, t_cur)
            return R_new, t_new

        def fine_phase(carry, parity, it):
            R_cur, t_cur = carry
            r, Ji, Jj = jacobians(R_cur, t_cur)

            # Window-local indices; endpoints outside the window are FIXED
            # (Dirichlet): their Jacobian columns are dropped, their effect
            # arrives through the residual.
            wi = ei - win0
            wj = ej - win0
            in_i = (wi >= 0) & (wi < W)
            in_j = (wj >= 0) & (wj < W)
            # Gauge: global node 0 never moves.
            in_i &= ei != 0
            in_j &= ej != 0
            wi = jnp.clip(wi, 0, W - 1)
            wj = jnp.clip(wj, 0, W - 1)
            Ji = Ji * in_i[:, None, None]
            Jj = Jj * in_j[:, None, None]

            we = w_e[:, None, None]
            H = jnp.zeros((W, 6, W, 6), R0.dtype)
            H = H.at[wi, :, wi, :].add(we * jnp.einsum("eab,eac->ebc", Ji, Ji))
            H = H.at[wj, :, wj, :].add(we * jnp.einsum("eab,eac->ebc", Jj, Jj))
            Hij = we * jnp.einsum("eab,eac->ebc", Ji, Jj)
            H = H.at[wi, :, wj, :].add(Hij)
            H = H.at[wj, :, wi, :].add(jnp.swapaxes(Hij, -1, -2))
            g = jnp.zeros((W, 6), R0.dtype)
            g = g.at[wi].add(-jnp.einsum("eab,ea->eb", Ji * we, r))
            g = g.at[wj].add(-jnp.einsum("eab,ea->eb", Jj * we, r))

            # Rows with no constraints (other shards' nodes, node 0): pin.
            diag = jnp.einsum("wawa->wa", H)
            pinned = jnp.sum(diag, axis=-1) < 1e-12
            H = H.at[jnp.arange(W), :, jnp.arange(W), :].add(
                pinned[:, None, None] * jnp.eye(6, dtype=R0.dtype))

            Hm = H.reshape(6 * W, 6 * W)
            Hm = Hm + damping * jnp.diag(jnp.maximum(jnp.diag(Hm), 1.0))
            Lc = jnp.linalg.cholesky(Hm)
            dx = jax.scipy.linalg.cho_solve(
                (Lc, True), g.reshape(-1)).reshape(W, 6)
            dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
            # Apply ONLY the own block (Schwarz restriction), and only on
            # this half-sweep's parity: simultaneous updates of ADJACENT
            # overlapping windows overcorrect shared error modes and
            # oscillate (each window's step assumes its halo fixed while
            # the neighbour moves it).  Red-black ordering makes adjacent
            # windows alternate — block Gauss-Seidel across the ring.
            active = (d % 2) == parity
            dx = dx * active.astype(dx.dtype)
            own_in_win = own0 - win0                     # offset of own rows
            dx_own = jax.lax.dynamic_slice(dx, (own_in_win, 0), (B, 6))
            dR, dt = se3_exp(dx_own)
            R_own = jax.lax.dynamic_slice(R_cur, (own0, 0, 0), (B, 3, 3))
            t_own = jax.lax.dynamic_slice(t_cur, (own0, 0), (B, 3))
            R_own, t_own = se3_compose(dR, dt, R_own, t_own)
            R_new = jax.lax.dynamic_update_slice(R_cur, R_own, (own0, 0, 0))
            t_new = jax.lax.dynamic_update_slice(t_cur, t_own, (own0, 0))

            # --- halo exchange: ring ppermute of boundary pose slices ---
            right = [(p, (p + 1) % D) for p in range(D)]
            left = [(p, (p - 1) % D) for p in range(D)]
            send_hi_R = R_own[B - halo:]                 # -> right neighbour
            send_hi_t = t_own[B - halo:]
            send_lo_R = R_own[:halo]                     # -> left neighbour
            send_lo_t = t_own[:halo]
            from_left_R = jax.lax.ppermute(send_hi_R, axis, right)
            from_left_t = jax.lax.ppermute(send_hi_t, axis, right)
            from_right_R = jax.lax.ppermute(send_lo_R, axis, left)
            from_right_t = jax.lax.ppermute(send_lo_t, axis, left)
            lo = own0 - halo
            upd_R = jax.lax.dynamic_update_slice(
                R_new, from_left_R, (jnp.maximum(lo, 0), 0, 0))
            upd_t = jax.lax.dynamic_update_slice(
                t_new, from_left_t, (jnp.maximum(lo, 0), 0))
            R_new = jnp.where(d > 0, upd_R, R_new)
            t_new = jnp.where(d > 0, upd_t, t_new)
            hi = own0 + B
            upd_R = jax.lax.dynamic_update_slice(
                R_new, from_right_R, (jnp.minimum(hi, n - halo), 0, 0))
            upd_t = jax.lax.dynamic_update_slice(
                t_new, from_right_t, (jnp.minimum(hi, n - halo), 0))
            R_new = jnp.where(d < D - 1, upd_R, R_new)
            t_new = jnp.where(d < D - 1, upd_t, t_new)

            # --- periodic full resync for long-range (loop) endpoints ---
            def resync(args):
                R_, t_ = args
                R_blk = jax.lax.dynamic_slice(R_, (own0, 0, 0), (B, 3, 3))
                t_blk = jax.lax.dynamic_slice(t_, (own0, 0), (B, 3))
                return (jax.lax.all_gather(R_blk, axis).reshape(n, 3, 3),
                        jax.lax.all_gather(t_blk, axis).reshape(n, 3))

            R_new, t_new = jax.lax.cond(
                (it + 1) % sync_every == 0, resync, lambda a: a,
                (R_new, t_new))
            return R_new, t_new

        def sweep(carry, it):
            R_cur, t_cur = carry
            # Phase schedule per GN "iteration": coarse, fine-red,
            # fine-black (it runs over 3*iters scan steps).
            R_new, t_new = jax.lax.switch(
                it % 3,
                [lambda c: coarse_phase(c, it),
                 lambda c: fine_phase(c, 0, it),
                 lambda c: fine_phase(c, 1, it)],
                (R_cur, t_cur))
            r = residuals(R_new, t_new)
            cost = jax.lax.psum(
                jnp.sum(w_p * jnp.sum(r * r, axis=-1)), axis)
            return (R_new, t_new), cost

        (R_fin, t_fin), costs = jax.lax.scan(
            sweep, (R0, t0), jnp.arange(3 * iters))
        # Final resync so every device returns the same full state.
        R_blk = jax.lax.dynamic_slice(R_fin, (own0, 0, 0), (B, 3, 3))
        t_blk = jax.lax.dynamic_slice(t_fin, (own0, 0), (B, 3))
        R_out = jax.lax.all_gather(R_blk, axis).reshape(n, 3, 3)
        t_out = jax.lax.all_gather(t_blk, axis).reshape(n, 3)
        return {"R": R_out, "t": t_out, "costs": costs}

    return jax.jit(run)
