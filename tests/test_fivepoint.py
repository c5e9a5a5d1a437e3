"""Nister 5-point solver tests: root finder, minimal solve, RANSAC."""

import numpy as np
import jax
import jax.numpy as jnp

from tinyslam.geometry.epipolar import essential_from_pose, sampson_error
from tinyslam.geometry.fivepoint import (
    durand_kerner_roots,
    five_point_essential,
    ransac_essential_5pt,
)
from tinyslam.geometry.se3 import se3_exp


def test_durand_kerner_known_roots():
    want = np.array([-3.0, -0.25, 0.5, 1.0, 2.0])
    p = np.poly(want).astype(np.float32)
    zr, zi = durand_kerner_roots(jnp.asarray(p)[None])
    got = np.sort(np.asarray(zr)[0])
    np.testing.assert_allclose(got, np.sort(want), atol=1e-3)
    assert np.abs(np.asarray(zi)).max() < 1e-3


def test_durand_kerner_batched_degree10():
    rng = np.random.default_rng(0)
    roots = rng.uniform(-2, 2, (8, 10))
    polys = np.stack([np.poly(r) for r in roots]).astype(np.float32)
    zr, zi = durand_kerner_roots(jnp.asarray(polys), iters=80)
    for b in range(8):
        got = np.sort(np.asarray(zr)[b])
        np.testing.assert_allclose(got, np.sort(roots[b]), atol=5e-2)


def _scene(rng, n=60):
    xi = np.array([0.2, -0.1, 0.05, 0.1, -0.15, 0.08], np.float32)
    R, t = se3_exp(jnp.asarray(xi))
    R, t = np.asarray(R), np.asarray(t)
    X = rng.uniform(-2, 2, (n, 3)).copy()
    X[:, 2] = rng.uniform(3, 8, n)
    x1 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    P2 = X @ R.T + t
    x2 = (P2[:, :2] / P2[:, 2:3]).astype(np.float32)
    E = np.asarray(essential_from_pose(jnp.asarray(R), jnp.asarray(t)))
    return x1, x2, E / np.linalg.norm(E)


def test_minimal_five_point_recovers_E():
    rng = np.random.default_rng(1)
    x1, x2, E_true = _scene(rng)
    Es = np.asarray(five_point_essential(jnp.asarray(x1[:5]), jnp.asarray(x2[:5])))
    assert Es.shape == (10, 3, 3)
    best = np.inf
    for E in Es:
        if not np.isfinite(E).all() or np.abs(E).max() > 100:
            continue
        err = np.asarray(
            sampson_error(jnp.asarray(E), jnp.asarray(x1[5:]), jnp.asarray(x2[5:]))
        )
        best = min(best, float(np.max(err)))
    assert best < 1e-8, best


def test_minimal_five_point_batched():
    rng = np.random.default_rng(2)
    x1, x2, _ = _scene(rng, n=30)
    s1 = jnp.asarray(np.stack([x1[:5], x1[5:10], x1[10:15]]))
    s2 = jnp.asarray(np.stack([x2[:5], x2[5:10], x2[10:15]]))
    Es = np.asarray(five_point_essential(s1, s2))
    assert Es.shape == (3, 10, 3, 3)
    for b in range(3):
        ok = False
        for E in Es[b]:
            if not np.isfinite(E).all() or np.abs(E).max() > 100:
                continue
            err = np.asarray(
                sampson_error(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2))
            )
            ok |= float(np.max(err)) < 1e-6
        assert ok, b


def test_ransac_5pt_with_noise_and_outliers():
    rng = np.random.default_rng(3)
    x1, x2, E_true = _scene(rng, n=200)
    # ~0.5 px noise at f=500 and 30% outliers.
    x2n = x2 + rng.normal(0, 1e-3, x2.shape).astype(np.float32)
    out = rng.random(200) < 0.3
    x2n[out] = rng.uniform(-0.5, 0.5, (int(out.sum()), 2)).astype(np.float32)
    res = ransac_essential_5pt(
        jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2n),
        jnp.ones(200, bool), inlier_threshold=3e-3,
    )
    n_in = int(res["num_inliers"])
    assert n_in > 0.5 * (~out).sum(), n_in
    E = np.asarray(res["E"])
    E = E / np.linalg.norm(E)
    d = min(np.abs(E - E_true).max(), np.abs(E + E_true).max())
    assert d < 0.05, d
