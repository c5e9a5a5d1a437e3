import numpy as np
import jax.numpy as jnp

from tinyslam.ops.fast import fast_score_map, nms3x3
from tests.golden import corner_image, fast_score_naive, nms3x3_naive


def test_score_map_matches_golden():
    rng = np.random.default_rng(1)
    img = rng.random((48, 56)).astype(np.float32)
    t, border = 0.15, 8
    score, m10, m01 = (np.asarray(a) for a in fast_score_map(jnp.asarray(img), t, border))
    gscore, gm10, gm01 = fast_score_naive(img, t, border)
    np.testing.assert_allclose(score, gscore, atol=1e-5)
    np.testing.assert_allclose(m10, gm10, atol=1e-4)
    np.testing.assert_allclose(m01, gm01, atol=1e-4)


def test_detects_synthetic_corner():
    img = corner_image(64, 64, 32, 32)
    score, _, _ = fast_score_map(jnp.asarray(img), 0.1, border=8)
    s = np.asarray(score)
    ys, xs = np.nonzero(s)
    assert len(ys) > 0
    # All detections cluster at the corner of the bright square.
    assert np.all(np.abs(ys - 32) <= 4) and np.all(np.abs(xs - 32) <= 4)


def test_streak12_misses_right_angle_corner():
    # Documents why streak_length defaults to 9: a perfect 90-degree corner
    # has only 11 of 16 ring points on the dark side, so the reference's
    # n=12 semantics (fast.wgsl:51-60) cannot detect it.
    img = corner_image(64, 64, 32, 32)
    score12, _, _ = fast_score_map(jnp.asarray(img), 0.1, border=8, streak=12)
    assert np.asarray(score12).max() == 0.0


def test_flat_image_no_corners():
    img = jnp.full((64, 64), 0.5)
    score, _, _ = fast_score_map(img, 0.05, border=8)
    assert np.asarray(score).max() == 0.0


def test_orientation_points_into_bright_side():
    img = corner_image(64, 64, 32, 32)  # bright quadrant is +x, +y
    score, m10, m01 = fast_score_map(jnp.asarray(img), 0.1, border=8)
    s = np.asarray(score)
    y, x = np.unravel_index(np.argmax(s), s.shape)
    ang = np.arctan2(np.asarray(m01)[y, x], np.asarray(m10)[y, x])
    # centroid should point into the bright quadrant: angle in (0, pi/2)
    assert 0.0 < ang < np.pi / 2


def test_nms_matches_golden_and_keeps_one_per_plateau():
    rng = np.random.default_rng(2)
    s = (rng.random((32, 32)).astype(np.float32) > 0.7) * rng.random((32, 32)).astype(np.float32)
    got = np.asarray(nms3x3(jnp.asarray(s)))
    want = nms3x3_naive(s)
    np.testing.assert_allclose(got, want)

    plateau = np.zeros((16, 16), np.float32)
    plateau[7:9, 7:9] = 1.0  # 2x2 tie
    kept = np.asarray(nms3x3(jnp.asarray(plateau)))
    assert (kept > 0).sum() == 1
