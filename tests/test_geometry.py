import numpy as np
import jax
import jax.numpy as jnp

from tinyslam.data.synthetic import (
    default_camera,
    look_at,
    normalized,
    project_points,
    random_points,
)
from tinyslam.geometry.epipolar import (
    decompose_essential,
    eight_point_essential,
    essential_from_pose,
    sampson_error,
    triangulate,
)
from tinyslam.geometry.pnp import pnp_refine
from tinyslam.geometry.ransac import ransac_essential, recover_pose
from tinyslam.geometry.se3 import se3_compose, se3_exp, se3_identity, se3_inverse


def _two_view(rng, n=200, noise_px=0.0, outlier_frac=0.0):
    """Scene + two cameras; returns cam, normalized correspondences and the
    relative pose (R21, t21) mapping camera1-frame -> camera2-frame."""
    cam = default_camera()
    X = random_points(rng, n, center=(0, 0, 0), extent=(4, 3, 2))
    R1, t1 = look_at(np.array([-0.4, 0.0, -6.0]), np.zeros(3))
    R2, t2 = look_at(np.array([0.5, 0.2, -5.8]), np.array([0.1, 0.0, 0.0]))
    uv1, vis1 = project_points(cam, R1, t1, X, rng=rng)
    uv2, vis2 = project_points(
        cam, R2, t2, X, noise_px=noise_px, outlier_frac=outlier_frac, rng=rng
    )
    vis = vis1 & vis2
    x1 = normalized(cam, uv1)
    x2 = normalized(cam, uv2)
    # relative pose: X2 = R21 X1 + t21 with R21 = R2 R1^T
    R1i, t1i = se3_inverse(jnp.asarray(R1), jnp.asarray(t1))
    R21, t21 = se3_compose(jnp.asarray(R2), jnp.asarray(t2), R1i, t1i)
    return cam, X, (R1, t1), (R2, t2), x1, x2, vis, np.asarray(R21), np.asarray(t21)


def test_essential_from_pose_epipolar_constraint():
    rng = np.random.default_rng(0)
    _, _, _, _, x1, x2, vis, R21, t21 = _two_view(rng)
    E = essential_from_pose(jnp.asarray(R21), jnp.asarray(t21))
    err = np.asarray(sampson_error(E, jnp.asarray(x1), jnp.asarray(x2)))
    assert np.max(err[vis]) < 1e-9


def test_eight_point_recovers_essential():
    rng = np.random.default_rng(1)
    _, _, _, _, x1, x2, vis, R21, t21 = _two_view(rng)
    w = vis.astype(np.float32)
    E_est = np.asarray(
        eight_point_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w))
    )
    E_true = np.asarray(essential_from_pose(jnp.asarray(R21), jnp.asarray(t21)))
    E_true = E_true / np.linalg.norm(E_true)
    E_est = E_est / np.linalg.norm(E_est)
    d = min(np.abs(E_est - E_true).max(), np.abs(E_est + E_true).max())
    assert d < 1e-3, d


def test_triangulate_recovers_points():
    rng = np.random.default_rng(2)
    _, X, (R1, t1), (R2, t2), x1, x2, vis, _, _ = _two_view(rng)
    Xh = np.asarray(
        triangulate(
            jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(x1),
            jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(x2),
        )
    )
    err = np.linalg.norm(Xh - X, axis=-1)
    assert np.percentile(err[vis], 95) < 1e-3


def test_ransac_and_pose_recovery_with_outliers():
    rng = np.random.default_rng(3)
    cam, X, (R1, t1), _, x1, x2, vis, R21, t21 = _two_view(
        rng, n=300, noise_px=0.5, outlier_frac=0.3
    )
    res = ransac_essential(
        jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(vis),
        inlier_threshold=3e-3,
    )
    assert int(res["num_inliers"]) > 0.5 * vis.sum()
    pose = recover_pose(res["E"], jnp.asarray(x1), jnp.asarray(x2), res["inliers"])
    from tinyslam.geometry.ransac import refine_relative_pose

    R_ref, t_ref = refine_relative_pose(
        pose["R"], pose["t"], jnp.asarray(x1), jnp.asarray(x2), res["inliers"],
        inlier_threshold=3e-3,
    )
    R_est = np.asarray(R_ref)
    t_est = np.asarray(t_ref)
    # Rotation error (degrees)
    cos = (np.trace(R_est @ R21.T) - 1) / 2
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert ang < 1.0, ang
    # Translation direction error (t is unit, sign fixed by cheirality)
    t_dir = t21 / np.linalg.norm(t21)
    dir_err = np.degrees(np.arccos(np.clip(np.dot(t_est, t_dir), -1, 1)))
    assert dir_err < 2.0, dir_err


def test_pnp_converges_from_perturbed_pose():
    rng = np.random.default_rng(4)
    cam = default_camera()
    X = random_points(rng, 200)
    R_gt, t_gt = look_at(np.array([0.3, -0.2, -5.5]), np.zeros(3))
    uv, vis = project_points(cam, R_gt, t_gt, X, noise_px=0.3, rng=rng)
    # Perturb the pose by ~3 degrees / 10 cm.
    dR, dt = se3_exp(jnp.asarray([0.08, -0.05, 0.06, 0.03, -0.02, 0.04], jnp.float32))
    R0, t0 = se3_compose(dR, dt, jnp.asarray(R_gt), jnp.asarray(t_gt))
    out = pnp_refine(
        cam, jnp.asarray(X, jnp.float32), jnp.asarray(uv), jnp.asarray(vis),
        R0, t0, iters=8,
    )
    R_est, t_est = np.asarray(out["R"]), np.asarray(out["t"])
    cos = (np.trace(R_est @ R_gt.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.1
    assert np.linalg.norm(t_est - t_gt) < 0.01
    assert int(out["num_inliers"]) > 0.9 * vis.sum()


def test_pnp_robust_to_outliers():
    rng = np.random.default_rng(5)
    cam = default_camera()
    X = random_points(rng, 300)
    R_gt, t_gt = look_at(np.array([-0.2, 0.1, -6.0]), np.zeros(3))
    uv, vis = project_points(cam, R_gt, t_gt, X, noise_px=0.3, outlier_frac=0.25, rng=rng)
    dR, dt = se3_exp(jnp.asarray([0.05, 0.05, -0.05, -0.02, 0.03, 0.02], jnp.float32))
    R0, t0 = se3_compose(dR, dt, jnp.asarray(R_gt), jnp.asarray(t_gt))
    out = pnp_refine(cam, jnp.asarray(X, jnp.float32), jnp.asarray(uv),
                     jnp.asarray(vis), R0, t0, iters=10)
    R_est, t_est = np.asarray(out["R"]), np.asarray(out["t"])
    cos = (np.trace(R_est @ R_gt.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.3
    assert np.linalg.norm(t_est - t_gt) < 0.03


def test_pnp_ransac_recovers_without_prior():
    """Relocalization: absolute pose from scratch (no initial guess), with
    30% wrong correspondences — the case GN-only pnp_refine cannot solve."""
    from tinyslam.geometry.pnp import pnp_ransac

    rng = np.random.default_rng(5)
    cam = default_camera()
    X = random_points(rng, 200, center=(0, 0, 4), extent=(4, 3, 2))
    R_gt, t_gt = look_at(np.array([1.5, -0.8, -2.0]), np.array([0.0, 0.0, 4.0]))
    uv, vis = project_points(cam, R_gt, t_gt, X)
    uv = uv + rng.normal(0, 0.4, uv.shape)
    # 30% outliers: scramble their pixels.
    n_out = 60
    out_idx = rng.choice(200, n_out, replace=False)
    uv[out_idx] = rng.uniform(0, 480, (n_out, 2))
    out = pnp_ransac(
        cam, jnp.asarray(X, jnp.float32), jnp.asarray(uv, jnp.float32),
        jnp.asarray(vis), jax.random.PRNGKey(0),
    )
    R_est, t_est = np.asarray(out["R"]), np.asarray(out["t"])
    assert np.linalg.norm(R_est - R_gt) < 0.02, np.linalg.norm(R_est - R_gt)
    assert np.linalg.norm(t_est - t_gt) < 0.05, np.linalg.norm(t_est - t_gt)
    assert int(out["num_inliers"]) > 110
