"""Sim(3) group operations + the scale-drift-aware pose graph.

The headline case (VERDICT r3 next-step #2): a loop trajectory with
injected exponential scale drift — the dominant monocular failure mode —
is corrected to sub-1% residual scale error by ONE Sim(3) loop edge, while
the SE(3) solver on the same problem structurally cannot absorb it.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tinyslam.backend.pose_graph import (
    optimize_pose_graph,
    optimize_pose_graph_sim3,
    sim3_edge_residual,
)
from tinyslam.geometry.se3 import se3_compose, se3_exp, se3_inverse
from tinyslam.geometry.sim3 import (
    sim3_apply,
    sim3_compose,
    sim3_exp,
    sim3_from_se3,
    sim3_inverse,
    sim3_log,
    sim3_to_se3,
)


def test_exp_log_roundtrip():
    rng = np.random.default_rng(3)
    xi = jnp.asarray(rng.normal(0, 0.6, (64, 7)).astype(np.float32))
    R, t, s = sim3_exp(xi)
    np.testing.assert_allclose(np.asarray(sim3_log(R, t, s)), np.asarray(xi),
                               atol=2e-5)


def test_exp_log_small_values():
    xi = jnp.asarray(np.array([
        np.zeros(7),
        np.r_[1e-7 * np.ones(3), np.zeros(3), 0.0],
        np.r_[np.zeros(3), 1e-7 * np.ones(3), 0.0],
        np.r_[np.zeros(6), 1e-7],
        np.r_[0.3, -0.2, 0.1, np.zeros(3), 0.4],     # pure scale + trans
        np.r_[np.zeros(3), 0.5, 0.1, -0.2, 0.0],     # pure rotation
    ], np.float32))
    R, t, s = sim3_exp(xi)
    np.testing.assert_allclose(np.asarray(sim3_log(R, t, s)), np.asarray(xi),
                               atol=1e-5)


def test_compose_matches_action():
    rng = np.random.default_rng(5)
    xa = jnp.asarray(rng.normal(0, 0.5, 7).astype(np.float32))
    xb = jnp.asarray(rng.normal(0, 0.5, 7).astype(np.float32))
    A, B = sim3_exp(xa), sim3_exp(xb)
    C = sim3_compose(*A, *B)
    pts = jnp.asarray(rng.normal(0, 2, (32, 3)).astype(np.float32))
    lhs = sim3_apply(*C, pts)
    rhs = sim3_apply(*A, sim3_apply(*B, pts))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-4)
    # inverse
    I = sim3_compose(*A, *sim3_inverse(*A))
    np.testing.assert_allclose(np.asarray(I[0]), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.asarray(I[1]), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(I[2]), 1.0, atol=1e-5)


def test_to_se3_preserves_camera_center():
    """sim3_to_se3 must keep the camera center: C = -R^T t / s."""
    rng = np.random.default_rng(9)
    xi = jnp.asarray(rng.normal(0, 0.5, 7).astype(np.float32))
    R, t, s = sim3_exp(xi)
    C_sim = -np.asarray(R).T @ np.asarray(t) / float(s)
    R_se, t_se = sim3_to_se3(R, t, s)
    C_se = -np.asarray(R_se).T @ np.asarray(t_se)
    np.testing.assert_allclose(C_se, C_sim, atol=1e-5)


def test_jacfwd_finite_at_zero():
    """The pose-graph Jacobians are jacfwd at xi = 0 — every small-value
    where-branch must stay differentiable there."""
    z = jnp.zeros(7)
    J = jax.jacfwd(lambda x: jnp.concatenate(
        [sim3_exp(x)[1], sim3_exp(x)[2][None]]))(z)
    assert bool(jnp.all(jnp.isfinite(J)))
    # d t / d rho at 0 is the identity; d s / d sigma at 0 is 1.
    np.testing.assert_allclose(np.asarray(J[:3, :3]), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(float(J[3, 6]), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# Scale-drift pose graph
# ---------------------------------------------------------------------------


def _circle_poses(n, radius=5.0):
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        w = np.array([0.0, a, 0.0], np.float32)
        R, _ = se3_exp(jnp.asarray(np.r_[np.zeros(3), w], np.float32))
        C = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))],
                     np.float32)
        t = -np.asarray(R) @ C
        poses.append((np.asarray(R), t.astype(np.float32)))
    return poses


def _drifted_problem(n=24, drift_per_step=1.01):
    """Odometry with exponentially growing translation scale (the monocular
    drift mode).  Returns (gt, est, odo_edges, loop_edge, k_total)."""
    gt = _circle_poses(n)
    est = [gt[0]]
    odo = []
    k = 1.0
    for i in range(n - 1):
        Ra, ta = gt[i]
        Rb, tb = gt[i + 1]
        Rai, tai = se3_inverse(jnp.asarray(Ra), jnp.asarray(ta))
        Rm, tm = se3_compose(jnp.asarray(Rb), jnp.asarray(tb), Rai, tai)
        k *= drift_per_step
        tm_d = np.asarray(tm) * k                     # drifted step length
        odo.append((i, i + 1, np.asarray(Rm), tm_d, 1.0, 1.0))
        Rn, tn = se3_compose(jnp.asarray(Rm), jnp.asarray(tm_d),
                             jnp.asarray(est[-1][0]), jnp.asarray(est[-1][1]))
        est.append((np.asarray(Rn), np.asarray(tn)))
    # Loop edge measured in NODE-0 scale (re-localization against the old
    # map): true relative pose, relative scale = accumulated drift of the
    # last node's local geometry w.r.t. node 0's.
    Ra, ta = gt[n - 1]
    R0, t0 = gt[0]
    Rai, tai = se3_inverse(jnp.asarray(Ra), jnp.asarray(ta))
    Rm, tm = se3_compose(jnp.asarray(R0), jnp.asarray(t0), Rai, tai)
    loop = (n - 1, 0, np.asarray(Rm), np.asarray(tm), 1.0 / k, 10.0)
    return gt, est, odo, loop, k


def _solve_sim3(est, edges, iters=25):
    E = len(edges)
    n = len(est)
    return optimize_pose_graph_sim3(
        jnp.asarray(np.stack([p[0] for p in est])),
        jnp.asarray(np.stack([p[1] for p in est])),
        jnp.ones((n,), jnp.float32),
        jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        jnp.asarray(np.stack([e[2] for e in edges])),
        jnp.asarray(np.stack([e[3] for e in edges])),
        jnp.asarray(np.array([e[4] for e in edges], np.float32)),
        jnp.asarray(np.ones(E, bool)),
        jnp.asarray(np.array([e[5] for e in edges], np.float32)),
        iters=iters,
    )


def test_sim3_edge_residual_zero_for_consistent():
    gt = _circle_poses(8)
    S2 = sim3_from_se3(jnp.asarray(gt[2][0]), jnp.asarray(gt[2][1]))
    S3 = sim3_from_se3(jnp.asarray(gt[3][0]), jnp.asarray(gt[3][1]))
    Sm = sim3_compose(*S3, *sim3_inverse(*S2))
    r = sim3_edge_residual(*S2, *S3, *Sm)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-5)


def test_sim3_graph_absorbs_scale_drift():
    n = 24
    gt, est, odo, loop, k = _drifted_problem(n, drift_per_step=1.01)
    assert k > 1.2  # the injected drift is ~26% end-to-end

    out = _solve_sim3(est, odo + [loop])
    R_opt = np.asarray(out["R"])
    t_opt = np.asarray(out["t"])
    s_opt = np.asarray(out["s"])

    # Corrected SE(3) centers vs ground truth.
    def center(R, t, s=1.0):
        return -(R.T @ t) / s

    errs = [np.linalg.norm(center(R_opt[i], t_opt[i], s_opt[i])
                           - center(*gt[i])) for i in range(n)]
    drift_before = np.linalg.norm(center(*est[n - 1]) - center(*gt[n - 1]))
    assert max(errs) < 0.15 * drift_before, (max(errs), drift_before)

    # Residual per-step scale error after correction: the corrected
    # relative translations must match ground truth to < 1%.
    ratios = []
    for i in range(n - 1):
        Ra, ta = sim3_to_se3(jnp.asarray(R_opt[i]), jnp.asarray(t_opt[i]),
                             jnp.asarray(s_opt[i]))
        Rb, tb = sim3_to_se3(jnp.asarray(R_opt[i + 1]), jnp.asarray(t_opt[i + 1]),
                             jnp.asarray(s_opt[i + 1]))
        step = np.linalg.norm(center(np.asarray(Rb), np.asarray(tb))
                              - center(np.asarray(Ra), np.asarray(ta)))
        Rga, tga = gt[i]
        Rgb, tgb = gt[i + 1]
        step_gt = np.linalg.norm(center(Rgb, tgb) - center(Rga, tga))
        ratios.append(step / step_gt)
    med_ratio = float(np.median(ratios))
    assert abs(med_ratio - 1.0) < 0.01, med_ratio

    assert float(out["costs"][-1]) < 1e-3 * float(out["costs"][0])


def test_se3_graph_cannot_absorb_scale_drift():
    """Control: the same problem through the SE(3) solver keeps most of the
    drift (documents WHY the Sim(3) solver exists)."""
    n = 24
    gt, est, odo, loop, k = _drifted_problem(n, drift_per_step=1.01)
    edges = [(i, j, R, t, w) for (i, j, R, t, _s, w) in odo + [loop]]
    E = len(edges)
    out = optimize_pose_graph(
        jnp.asarray(np.stack([p[0] for p in est])),
        jnp.asarray(np.stack([p[1] for p in est])),
        jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        jnp.asarray(np.stack([e[2] for e in edges])),
        jnp.asarray(np.stack([e[3] for e in edges])),
        jnp.asarray(np.ones(E, bool)),
        jnp.asarray(np.array([e[4] for e in edges], np.float32)),
        iters=25,
    )
    R_opt = np.asarray(out["R"])
    t_opt = np.asarray(out["t"])

    def center(R, t):
        return -(R.T @ t)

    # Per-step scale ratio stays far from 1 somewhere along the chain: the
    # SE(3) graph can only translate the drift around, not remove it.
    ratios = []
    for i in range(n - 1):
        step = np.linalg.norm(center(R_opt[i + 1], t_opt[i + 1])
                              - center(R_opt[i], t_opt[i]))
        step_gt = np.linalg.norm(center(*gt[i + 1]) - center(*gt[i]))
        ratios.append(step / step_gt)
    worst = float(np.max(np.abs(np.asarray(ratios) - 1.0)))
    assert worst > 0.05, worst
