import numpy as np
import jax.numpy as jnp

from tinyslam.geometry.se3 import (
    se3_apply,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_log,
)


def _rand_xi(rng, n, max_angle=np.pi - 0.05):
    w = rng.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True)
    w *= rng.uniform(1e-5, max_angle, (n, 1))
    v = rng.normal(size=(n, 3))
    return np.concatenate([v, w], axis=-1).astype(np.float32)


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    w = _rand_xi(rng, 64)[:, 3:]
    R = so3_exp(jnp.asarray(w))
    w2 = np.asarray(so3_log(R))
    np.testing.assert_allclose(w2, w, atol=2e-4)


def test_so3_log_near_pi_and_identity():
    rng = np.random.default_rng(1)
    for angle in [1e-8, 1e-4, np.pi - 1e-4]:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        w = (axis * angle).astype(np.float32)
        R = so3_exp(jnp.asarray(w))
        w2 = np.asarray(so3_log(R))
        # Axis-angle is ambiguous at pi (w vs -w); compare rotations.
        R2 = so3_exp(jnp.asarray(w2))
        np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-4)


def test_rotation_orthonormal():
    rng = np.random.default_rng(2)
    w = _rand_xi(rng, 32)[:, 3:]
    R = np.asarray(so3_exp(jnp.asarray(w)))
    I = np.eye(3)
    for r in R:
        np.testing.assert_allclose(r @ r.T, I, atol=1e-5)
        assert np.linalg.det(r) > 0.99


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(3)
    xi = _rand_xi(rng, 64, max_angle=3.0)
    R, t = se3_exp(jnp.asarray(xi))
    xi2 = np.asarray(se3_log(R, t))
    np.testing.assert_allclose(xi2, xi, atol=3e-4)


def test_se3_compose_inverse():
    rng = np.random.default_rng(4)
    xi = _rand_xi(rng, 16, max_angle=2.0)
    R, t = se3_exp(jnp.asarray(xi))
    Ri, ti = se3_inverse(R, t)
    Rc, tc = se3_compose(R, t, Ri, ti)
    np.testing.assert_allclose(np.asarray(Rc), np.broadcast_to(np.eye(3), Rc.shape), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tc), 0.0, atol=1e-5)


def test_se3_apply_matches_matrix():
    rng = np.random.default_rng(5)
    xi = _rand_xi(rng, 1, max_angle=2.0)[0]
    R, t = se3_exp(jnp.asarray(xi))
    x = rng.normal(size=(10, 3)).astype(np.float32)
    got = np.asarray(se3_apply(R, t, jnp.asarray(x)))
    want = x @ np.asarray(R).T + np.asarray(t)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_identity():
    R, t = se3_identity()
    np.testing.assert_allclose(np.asarray(R), np.eye(3))
    np.testing.assert_allclose(np.asarray(t), 0.0)
