"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY §4.5) —
the same bodies run unchanged on real pod slices."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinyslam.backend.ba import bundle_adjust
from tinyslam.config import FrontendConfig, MeshConfig
from tinyslam.parallel import (
    bundle_adjust_sharded,
    extract_features_batch,
    make_mesh,
)
from tests.test_ba import _perturb, _window_problem


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(MeshConfig(frame_axis=2, landmark_axis=4))


def test_mesh_shape(mesh):
    assert mesh.shape == {"frame": 2, "landmark": 4}


def test_dist_ba_matches_single_device(mesh):
    rng = np.random.default_rng(0)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng, K=6, L=256)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    pose_free = np.r_[[False, False], np.ones(4, bool)]

    args = (cam, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
            jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free))
    single = bundle_adjust(*args, max_iters=8)
    dist = bundle_adjust_sharded(mesh, *args, max_iters=8)

    # Same optimization up to float reduction order.
    np.testing.assert_allclose(
        np.asarray(dist["R"]), np.asarray(single["R"]), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(dist["t"]), np.asarray(single["t"]), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(dist["X"]), np.asarray(single["X"]), atol=5e-3
    )
    assert float(dist["cost"]) < 0.1 * float(dist["initial_cost"])


def test_dist_ba_reduces_cost_with_landmark_sharding(mesh):
    rng = np.random.default_rng(1)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng, K=5, L=512)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    pose_free = np.r_[[False, False], np.ones(3, bool)]
    point_valid = rng.random(512) > 0.2
    out = bundle_adjust_sharded(
        mesh, cam, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
        jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free),
        point_valid=jnp.asarray(point_valid), max_iters=8,
    )
    assert float(out["cost"]) < 0.2 * float(out["initial_cost"])
    # Output X is resharded over the mesh but numerically complete.
    assert np.isfinite(np.asarray(out["X"])).all()


def test_frontend_dp_matches_per_frame(mesh):
    from tests.golden import dot_grid
    from tinyslam.frontend import OrbFrontend

    cfg = FrontendConfig(height=96, width=128, num_levels=2,
                         features_per_level=64, threshold=0.1,
                         adaptive_threshold=False)
    rng = np.random.default_rng(2)
    images = np.stack([
        dot_grid(96, 128, spacing=12 + i, offset=24) for i in range(4)
    ]).astype(np.float32)

    batch = extract_features_batch(jnp.asarray(images), cfg.threshold, cfg,
                                   mesh=mesh)
    fe = OrbFrontend(cfg)
    for i in range(4):
        single = fe.extract(jnp.asarray(images[i]))
        np.testing.assert_allclose(
            np.asarray(batch.xy[i]), np.asarray(single.xy), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(batch.desc[i]), np.asarray(single.desc)
        )
        np.testing.assert_array_equal(
            np.asarray(batch.valid[i]), np.asarray(single.valid)
        )


def test_dist_pose_graph_matches_single_device(mesh):
    from tests.test_pose_graph import _circle_poses, _relative
    from tinyslam.backend.pose_graph import optimize_pose_graph
    from tinyslam.parallel import optimize_pose_graph_sharded
    from tinyslam.geometry.se3 import se3_compose, se3_exp

    rng = np.random.default_rng(3)
    n = 16
    gt = _circle_poses(n)
    est = [gt[0]]
    edges = []
    for i in range(n - 1):
        Rm, tm = _relative(gt[i], gt[i + 1])
        noise = np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]
        dR, dt = se3_exp(jnp.asarray(noise.astype(np.float32)))
        Rmn, tmn = se3_compose(dR, dt, jnp.asarray(Rm), jnp.asarray(tm))
        edges.append((i, i + 1, np.asarray(Rmn), np.asarray(tmn), 1.0))
        Rn, tn = se3_compose(Rmn, tmn, jnp.asarray(est[-1][0]),
                             jnp.asarray(est[-1][1]))
        est.append((np.asarray(Rn), np.asarray(tn)))
    Rm, tm = _relative(gt[n - 1], gt[0])
    edges.append((n - 1, 0, Rm, tm, 10.0))

    # Pad edge set to a multiple of the total device count (8) with
    # invalid edges: they must contribute nothing.
    E = len(edges)
    Ep = ((E + 7) // 8) * 8
    ei = np.array([e[0] for e in edges] + [0] * (Ep - E), np.int32)
    ej = np.array([e[1] for e in edges] + [1] * (Ep - E), np.int32)
    eR = np.stack([e[2] for e in edges] + [np.eye(3, dtype=np.float32)] * (Ep - E))
    et = np.stack([e[3] for e in edges] + [np.zeros(3, np.float32)] * (Ep - E))
    ev = np.array([True] * E + [False] * (Ep - E))
    ew = np.array([e[4] for e in edges] + [0.0] * (Ep - E), np.float32)

    args = (
        jnp.asarray(np.stack([p[0] for p in est])),
        jnp.asarray(np.stack([p[1] for p in est])),
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(eR), jnp.asarray(et),
        jnp.asarray(ev), jnp.asarray(ew),
    )
    single = optimize_pose_graph(*args, iters=10)

    # Edge-shard over the full 8-device mesh (flattened axes via a 1D mesh).
    flat = make_mesh(MeshConfig(frame_axis=1, landmark_axis=8))
    dist = optimize_pose_graph_sharded(flat, *args, iters=10)

    np.testing.assert_allclose(
        np.asarray(dist["R"]), np.asarray(single["R"]), atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(dist["t"]), np.asarray(single["t"]), atol=5e-3)
    assert float(dist["costs"][-1]) < float(dist["costs"][0])


def test_node_sharded_pose_graph_parity(mesh):
    """VERDICT r3 next-step #8: the node-sharded (overlapping-Schwarz +
    ppermute halo) pose graph converges to the replicated solver's optimum
    on a noisy loop graph."""
    from tests.test_pose_graph import _circle_poses, _relative
    from tinyslam.backend.pose_graph import optimize_pose_graph
    from tinyslam.parallel.dist_pose_graph import (
        optimize_pose_graph_node_sharded,
    )

    rng = np.random.default_rng(5)
    n = 64
    gt = _circle_poses(n)
    from tinyslam.geometry.se3 import se3_compose, se3_exp

    est = [gt[0]]
    edges = []
    for i in range(n - 1):
        Rm, tm = _relative(gt[i], gt[i + 1])
        noise = np.r_[rng.normal(0, 0.01, 3),
                      rng.normal(0, 0.005, 3)].astype(np.float32)
        dR, dt = se3_exp(jnp.asarray(noise))
        Rmn, tmn = se3_compose(dR, dt, jnp.asarray(Rm), jnp.asarray(tm))
        edges.append((i, i + 1, np.asarray(Rmn), np.asarray(tmn), 1.0))
        Rn, tn = se3_compose(jnp.asarray(Rmn), jnp.asarray(tmn),
                             jnp.asarray(est[-1][0]), jnp.asarray(est[-1][1]))
        est.append((np.asarray(Rn), np.asarray(tn)))
    # A long-range loop edge plus a mid-range one (exercise the stale-
    # endpoint resync path, not just the chain halo).
    for a, b, w in ((n - 1, 0, 10.0), (10, 40, 5.0)):
        Rm, tm = _relative(gt[a], gt[b])
        edges.append((a, b, np.asarray(Rm), np.asarray(tm), w))

    E = len(edges)
    args = (
        jnp.asarray(np.stack([p[0] for p in est])),
        jnp.asarray(np.stack([p[1] for p in est])),
        jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        jnp.asarray(np.stack([e[2] for e in edges])),
        jnp.asarray(np.stack([e[3] for e in edges])),
        jnp.asarray(np.ones(E, bool)),
        jnp.asarray(np.array([e[4] for e in edges], np.float32)),
    )
    ref = optimize_pose_graph(*args, iters=25)
    out = optimize_pose_graph_node_sharded(
        mesh, *args, iters=80, halo=12, sync_every=4, axis="landmark")

    def centers(R, t):
        R, t = np.asarray(R), np.asarray(t)
        return np.stack([-(R[i].T @ t[i]) for i in range(len(R))])

    c_ref = centers(ref["R"], ref["t"])
    c_out = centers(out["R"], out["t"])
    err = np.linalg.norm(c_out - c_ref, axis=-1)
    assert err.max() < 0.05, err.max()
    # And both solvers actually moved the drifted estimate.
    c_est = centers(args[0], args[1])
    assert np.linalg.norm(c_est - c_ref, axis=-1).max() > 0.1
