import numpy as np
import jax.numpy as jnp

from tinyslam.backend.pose_graph import edge_residual, optimize_pose_graph
from tinyslam.geometry.se3 import se3_compose, se3_exp, se3_inverse


def _circle_poses(n, radius=5.0):
    """Ground-truth poses around a circle (world->camera)."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        w = np.array([0.0, a, 0.0], np.float32)
        R, _ = se3_exp(jnp.asarray(np.r_[np.zeros(3), w], np.float32))
        C = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))], np.float32)
        t = -np.asarray(R) @ C
        poses.append((np.asarray(R), t.astype(np.float32)))
    return poses


def _relative(pa, pb):
    """T_ab with T_b = T_ab o T_a."""
    Ra, ta = pa
    Rb, tb = pb
    Rai, tai = se3_inverse(jnp.asarray(Ra), jnp.asarray(ta))
    R, t = se3_compose(jnp.asarray(Rb), jnp.asarray(tb), Rai, tai)
    return np.asarray(R), np.asarray(t)


def test_edge_residual_zero_for_consistent():
    poses = _circle_poses(8)
    Rm, tm = _relative(poses[2], poses[3])
    r = edge_residual(
        jnp.asarray(poses[2][0]), jnp.asarray(poses[2][1]),
        jnp.asarray(poses[3][0]), jnp.asarray(poses[3][1]),
        jnp.asarray(Rm), jnp.asarray(tm),
    )
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-5)


def test_pose_graph_closes_loop():
    rng = np.random.default_rng(0)
    n = 24
    gt = _circle_poses(n)

    # Odometry integration with noise -> drifting estimate.
    est = [gt[0]]
    odo_edges = []
    for i in range(n - 1):
        Rm, tm = _relative(gt[i], gt[i + 1])
        noise = np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)].astype(np.float32)
        dR, dt = se3_exp(jnp.asarray(noise))
        Rmn, tmn = se3_compose(dR, dt, jnp.asarray(Rm), jnp.asarray(tm))
        Rmn, tmn = np.asarray(Rmn), np.asarray(tmn)
        odo_edges.append((i, i + 1, Rmn, tmn, 1.0))
        Rn, tn = se3_compose(jnp.asarray(Rmn), jnp.asarray(tmn),
                             jnp.asarray(est[-1][0]), jnp.asarray(est[-1][1]))
        est.append((np.asarray(Rn), np.asarray(tn)))

    # Loop closure: accurate measurement from last node back to node 0.
    Rm, tm = _relative(gt[n - 1], gt[0])
    edges = odo_edges + [(n - 1, 0, Rm, tm, 10.0)]

    def camera_center(R, t):
        return -R.T @ t

    drift_before = np.linalg.norm(
        camera_center(*est[n - 1]) - camera_center(*gt[n - 1])
    )

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
        iters=15,
    )
    R_opt = np.asarray(out["R"])
    t_opt = np.asarray(out["t"])
    errs = [
        np.linalg.norm(camera_center(R_opt[i], t_opt[i]) - camera_center(*gt[i]))
        for i in range(n)
    ]
    # Loop closure should spread the drift: max node error well under the
    # raw endpoint drift, and the closing edge satisfied.
    assert max(errs) < 0.5 * drift_before, (max(errs), drift_before)
    assert float(out["costs"][-1]) < float(out["costs"][0])


def test_pose_graph_respects_edge_validity():
    gt = _circle_poses(6)
    est = [(p[0].copy(), p[1].copy()) for p in gt]
    # A wildly wrong but INVALID edge must have no effect.
    bogus_R, bogus_t = _relative(gt[0], gt[3])
    bogus_t = bogus_t + 100.0
    edges_i = np.array([0, 1, 2, 3, 4, 0], np.int32)
    edges_j = np.array([1, 2, 3, 4, 5, 3], np.int32)
    Rm, tm, wv = [], [], []
    for a, b in zip(edges_i[:-1], edges_j[:-1]):
        R_, t_ = _relative(gt[a], gt[b])
        Rm.append(R_), tm.append(t_), wv.append(True)
    Rm.append(bogus_R), tm.append(bogus_t), wv.append(False)
    out = optimize_pose_graph(
        jnp.asarray(np.stack([p[0] for p in est])),
        jnp.asarray(np.stack([p[1] for p in est])),
        jnp.asarray(edges_i), jnp.asarray(edges_j),
        jnp.asarray(np.stack(Rm)), jnp.asarray(np.stack(tm)),
        jnp.asarray(np.array(wv)), iters=5,
    )
    for i in range(6):
        np.testing.assert_allclose(np.asarray(out["R"])[i], gt[i][0], atol=1e-4)
        np.testing.assert_allclose(np.asarray(out["t"])[i], gt[i][1], atol=1e-4)
