"""A/B: the trained decorrelated BRIEF pattern vs raw Gaussian pairs
(VERDICT r3 next-step #6).  Outcome: the decorrelated pattern has lower
bit correlation but WORSE matching (boundary-straddling tests flip under
noise), so the Gaussian pattern ships — these tests pin both halves of
that justification."""

import numpy as np
import jax.numpy as jnp
import pytest

from tinyslam.ops.brief import BRIEF_PATTERN, RANDOM_PATTERN


def test_learned_pattern_exists_and_valid():
    from tinyslam.ops.brief_pattern_learned import LEARNED_PATTERN

    assert LEARNED_PATTERN.shape == (256, 2, 2)
    assert np.abs(LEARNED_PATTERN).max() <= 13
    assert not np.any(np.all(LEARNED_PATTERN[:, 0] == LEARNED_PATTERN[:, 1],
                             axis=-1))
    # No duplicate tests (the raw Gaussian pool contains exact duplicates).
    flat = LEARNED_PATTERN.reshape(256, 4)
    assert len({tuple(r) for r in flat.tolist()}) == 256
    # The SHIPPED pattern is the Gaussian one — the A/B winner.
    np.testing.assert_array_equal(BRIEF_PATTERN, RANDOM_PATTERN)


def _bits(pattern, patches, R=15):
    a = patches[:, pattern[:, 0, 1] + R, pattern[:, 0, 0] + R]
    b = patches[:, pattern[:, 1, 1] + R, pattern[:, 1, 0] + R]
    return (a > b).astype(np.float32)


def test_learned_pattern_less_correlated():
    """Bit statistics on held-out smoothed-noise patches: the learned
    pattern's mean |pairwise correlation| and mean |bias| must beat the
    Gaussian pattern's."""
    rng = np.random.default_rng(99)            # != training seed
    raw = rng.random((4000, 41, 41))
    k = np.ones(5) / 5.0
    for ax in (1, 2):
        raw = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, raw)
    patches = raw[:, 5:36, 5:36]

    def stats(pat):
        b = _bits(np.asarray(pat), patches)
        m = b.mean(axis=0)
        bc = b - m[None, :]
        nn = np.sqrt((bc * bc).sum(axis=0)) + 1e-9
        C = (bc.T @ bc) / np.outer(nn, nn)
        np.fill_diagonal(C, 0.0)
        return np.abs(m - 0.5).mean(), np.abs(C).mean()

    from tinyslam.ops.brief_pattern_learned import LEARNED_PATTERN

    bias_l, corr_l = stats(LEARNED_PATTERN)
    bias_r, corr_r = stats(RANDOM_PATTERN)
    assert corr_l < corr_r, (corr_l, corr_r)
    # (bias is only meaningfully reduced on the CORNER patch distribution
    # the pattern was trained on; on isotropic noise both are ~0.006.)


def test_shipped_pattern_wins_matching():
    """Planted-match recovery under rotation + noise: the SHIPPED Gaussian
    pattern must match at least as well as the decorrelated alternative
    (it measured 537 vs 469 matches when the choice was made — if this
    flips after a retrain, flip the default)."""
    from tinyslam.data.synthetic import TexturedRoom, look_at
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.config import FrontendConfig
    from tinyslam.frontend.orb import extract_features
    from tinyslam.ops.hamming import match_descriptors
    from tinyslam.ops import brief as B

    rng = np.random.default_rng(5)
    room = TexturedRoom(rng, tex_res=256, octaves=3)
    cam = PinholeCamera.create(fx=520.0, fy=520.0, cx=319.5, cy=239.5)
    C = np.array([0.2, 0.1, 0.3])
    R1, t1 = look_at(C, np.array([0.0, 0.0, 6.0]))
    th = np.deg2rad(12.0)                      # pure rotation: exact overlap
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    R2, t2 = Rz @ R1, Rz @ t1
    img1 = room.render(cam, R1, t1, 640, 480)
    img2 = room.render(cam, R2, t2, 640, 480)
    img1 += rng.normal(0, 0.01, img1.shape).astype(np.float32)
    img2 += rng.normal(0, 0.01, img2.shape).astype(np.float32)
    cfg = FrontendConfig(interpolate_descriptors=True)

    def score(pattern):
        saved = B.BRIEF_PATTERN
        B.BRIEF_PATTERN = pattern
        # The descriptor kernels are jitted with the pattern captured at
        # trace time — bust their caches or the swap is a no-op.
        B.brief_descriptors.clear_cache()
        B._binned_tables.cache_clear()
        try:
            import jax

            f = jax.jit(lambda im: extract_features(im, cfg.threshold, cfg))
            f1 = f(jnp.asarray(img1))
            f2 = f(jnp.asarray(img2))
        finally:
            B.BRIEF_PATTERN = saved
            B.brief_descriptors.clear_cache()
            B._binned_tables.cache_clear()
        m = match_descriptors(f1.desc, f1.valid, f2.desc, f2.valid)
        return int(np.asarray(m["valid"]).sum())

    from tinyslam.ops.brief_pattern_learned import LEARNED_PATTERN

    s_learned = score(np.asarray(LEARNED_PATTERN))
    s_random = score(np.asarray(RANDOM_PATTERN))
    assert s_random >= 0.95 * s_learned, (s_random, s_learned)
    assert s_random > 100
