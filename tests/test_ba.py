import numpy as np
import jax.numpy as jnp

from tinyslam.backend.ba import bundle_adjust
from tinyslam.data.synthetic import (
    default_camera,
    orbit_trajectory,
    project_points,
    random_points,
)
from tinyslam.geometry.se3 import se3_compose, se3_exp


def _window_problem(rng, K=8, L=300, noise_px=0.5, drop=0.2):
    cam = default_camera()
    X = random_points(rng, L)
    poses = orbit_trajectory(K)
    z = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), bool)
    for k, (R, t) in enumerate(poses):
        uv, vis = project_points(cam, R, t, X, noise_px=noise_px, rng=rng)
        vis &= rng.random(L) > drop
        z[:, k] = uv
        mask[:, k] = vis
    R_gt = np.stack([p[0] for p in poses])
    t_gt = np.stack([p[1] for p in poses])
    return cam, X.astype(np.float32), R_gt, t_gt, z, mask


def _perturb(rng, R_gt, t_gt, X, rot=0.02, trans=0.05, pt=0.05, keep_first=2):
    K = len(R_gt)
    xi = np.concatenate(
        [rng.normal(0, trans, (K, 3)), rng.normal(0, rot, (K, 3))], axis=-1
    ).astype(np.float32)
    xi[:keep_first] = 0.0
    dR, dt = se3_exp(jnp.asarray(xi))
    R0, t0 = se3_compose(dR, dt, jnp.asarray(R_gt), jnp.asarray(t_gt))
    X0 = X + rng.normal(0, pt, X.shape).astype(np.float32)
    return np.asarray(R0), np.asarray(t0), X0


def test_ba_reduces_cost_and_recovers_geometry():
    rng = np.random.default_rng(0)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    pose_free = np.ones(len(R_gt), bool)
    pose_free[:2] = False  # gauge: fix first two poses (scale + frame)

    out = bundle_adjust(
        cam, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
        jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free),
        max_iters=12,
    )
    assert float(out["cost"]) < 0.05 * float(out["initial_cost"])
    R_est, t_est = np.asarray(out["R"]), np.asarray(out["t"])
    for k in range(len(R_gt)):
        cos = (np.trace(R_est[k] @ R_gt[k].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2, k
        assert np.linalg.norm(t_est[k] - t_gt[k]) < 0.02, k


def test_ba_fixed_poses_stay_fixed():
    rng = np.random.default_rng(1)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng, K=5, L=150)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    pose_free = np.ones(5, bool)
    pose_free[:2] = False
    out = bundle_adjust(
        cam, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
        jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free), max_iters=5,
    )
    np.testing.assert_array_equal(np.asarray(out["R"])[:2], R0[:2])
    np.testing.assert_array_equal(np.asarray(out["t"])[:2], t0[:2])


def test_ba_robust_to_outlier_observations():
    rng = np.random.default_rng(2)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng, noise_px=0.3)
    # Corrupt 10% of visible observations.
    corrupt = (rng.random(mask.shape) < 0.1) & mask
    z = z + np.where(corrupt[..., None], rng.normal(0, 50, (*mask.shape, 2)), 0).astype(
        np.float32
    )
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X, rot=0.01, trans=0.02, pt=0.02)
    pose_free = np.ones(len(R_gt), bool)
    pose_free[:2] = False
    out = bundle_adjust(
        cam, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
        jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free), max_iters=12,
    )
    R_est, t_est = np.asarray(out["R"]), np.asarray(out["t"])
    for k in range(len(R_gt)):
        cos = (np.trace(R_est[k] @ R_gt[k].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5, k
        assert np.linalg.norm(t_est[k] - t_gt[k]) < 0.05, k


def test_ba_handles_invalid_landmarks():
    rng = np.random.default_rng(3)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng, K=4, L=100)
    point_valid = rng.random(100) > 0.3
    out = bundle_adjust(
        cam, jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(X),
        jnp.asarray(z), jnp.asarray(mask),
        jnp.asarray(np.r_[False, False, True, True]),
        point_valid=jnp.asarray(point_valid),
        max_iters=3,
    )
    assert np.isfinite(float(out["cost"]))
    # Invalid landmarks must not move.
    np.testing.assert_allclose(
        np.asarray(out["X"])[~point_valid], X[~point_valid], atol=1e-6
    )
