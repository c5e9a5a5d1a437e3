import numpy as np
import jax.numpy as jnp

from tinyslam.ops.brief import BRIEF_PATTERN, brief_descriptors
from tests.golden import brief_naive


def test_pattern_properties():
    assert BRIEF_PATTERN.shape == (256, 2, 2)
    assert np.abs(BRIEF_PATTERN).max() <= 13
    # No degenerate pairs.
    assert not np.any(np.all(BRIEF_PATTERN[:, 0] == BRIEF_PATTERN[:, 1], axis=-1))
    # Deterministic across imports: the active pattern is the committed
    # learned table (falls back to the deterministic Gaussian pattern).
    import importlib

    import tinyslam.ops.brief as B

    np.testing.assert_array_equal(BRIEF_PATTERN, importlib.reload(B).BRIEF_PATTERN)
    from tinyslam.ops.brief import RANDOM_PATTERN, _make_pattern

    np.testing.assert_array_equal(RANDOM_PATTERN, _make_pattern())


def test_brief_matches_golden():
    rng = np.random.default_rng(3)
    img = rng.random((64, 80)).astype(np.float32)
    n = 12
    xy = np.stack(
        [rng.integers(20, 60, n), rng.integers(20, 44, n)], axis=-1
    ).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-2:] = False
    got = np.asarray(
        brief_descriptors(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle), jnp.asarray(valid))
    )
    want = brief_naive(img, xy, angle, valid)
    np.testing.assert_array_equal(got, want)


def test_brief_invalid_slots_zero():
    img = jnp.zeros((32, 32)) + 0.5
    xy = jnp.asarray([[16.0, 16.0]])
    d = brief_descriptors(img, xy, jnp.asarray([0.0]), jnp.asarray([False]))
    assert np.asarray(d).sum() == 0


def test_brief_rotation_steers_descriptor():
    """Rotating the image content and the feature angle together should keep
    the descriptor approximately invariant (the point of steered BRIEF)."""
    rng = np.random.default_rng(4)
    # Smooth random image (blur noise) so nearest-sampling artifacts are small.
    from tinyslam.ops.image import gaussian_blur

    base = rng.random((96, 96)).astype(np.float32)
    img = np.asarray(gaussian_blur(jnp.asarray(base), 3.0))
    c = 48.0
    d0 = np.asarray(
        brief_descriptors(
            jnp.asarray(img), jnp.asarray([[c, c]]), jnp.asarray([0.0]), jnp.asarray([True])
        )
    )
    # Rotate image by 90 degrees around center: new[y, x] = old[x, H-1-y]
    img90 = np.rot90(img, k=-1).copy()  # clockwise: point (x,y) -> (H-1-y, x)
    d90 = np.asarray(
        brief_descriptors(
            jnp.asarray(img90),
            jnp.asarray([[95.0 - c, c]]),
            jnp.asarray([np.float32(np.pi / 2)]),
            jnp.asarray([True]),
        )
    )
    ham = sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(d0[0], d90[0]))
    # Perfect invariance is impossible with nearest sampling; require strong
    # agreement (random descriptors differ by ~128 bits).
    assert ham < 40, f"hamming {ham}"


def test_brief_binned_matches_golden():
    from tinyslam.ops.brief import brief_descriptors_binned
    from tests.golden import brief_binned_naive

    rng = np.random.default_rng(11)
    img = rng.random((96, 128)).astype(np.float32)
    n = 16
    xy = np.stack(
        [rng.integers(20, 108, n), rng.integers(20, 76, n)], axis=-1
    ).astype(np.float32)
    xy += rng.uniform(-0.4, 0.4, xy.shape).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-3:] = False
    got = np.asarray(brief_descriptors_binned(
        jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle),
        jnp.asarray(valid)))
    want = brief_binned_naive(img, xy, angle, valid)
    np.testing.assert_array_equal(got, want)


def test_brief_binned_close_to_continuous():
    """Quantizing orientation to 11.25-degree bins must stay descriptor-
    compatible with the continuous path: small Hamming distance between the
    two encodings of the same feature."""
    from tinyslam.ops.brief import brief_descriptors_binned
    from tinyslam.ops.image import gaussian_blur
    from tests.golden import hamming_naive

    rng = np.random.default_rng(12)
    img = np.asarray(gaussian_blur(jnp.asarray(
        rng.random((96, 128)).astype(np.float32)), 2.0))
    n = 24
    xy = np.stack(
        [rng.integers(21, 107, n), rng.integers(21, 75, n)], axis=-1
    ).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    valid = np.ones(n, bool)
    d_cont = np.asarray(brief_descriptors(
        jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle),
        jnp.asarray(valid)))
    d_bin = np.asarray(brief_descriptors_binned(
        jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle),
        jnp.asarray(valid)))
    dists = np.diagonal(hamming_naive(d_cont, d_bin))
    # Same feature under the two encodings: far below the 64-bit match gate.
    assert np.median(dists) <= 24, f"median {np.median(dists)}"
    assert dists.mean() <= 32, f"mean {dists.mean()}"
