import numpy as np
import jax
import jax.numpy as jnp

from tinyslam.config import FrontendConfig
from tinyslam.frontend import OrbFrontend
from tests.golden import dot_grid


def _cfg(**kw):
    base = dict(height=96, width=128, num_levels=3, features_per_level=64,
                threshold=0.1)
    base.update(kw)
    return FrontendConfig(**base)


def test_extract_shapes_and_counts():
    cfg = _cfg()
    fe = OrbFrontend(cfg)
    img = jnp.asarray(dot_grid(96, 128, spacing=12))
    feats = fe.extract(img)
    n = cfg.max_features
    assert feats.xy.shape == (n, 2)
    assert feats.desc.shape == (n, 8)
    assert int(feats.count) > 0


def test_extract_deterministic():
    # Two fresh frontends (extract() adapts its threshold statefully, so
    # determinism is process-level: same construction + same inputs).
    rng = np.random.default_rng(9)
    img = jnp.asarray(rng.random((96, 128)).astype(np.float32))
    f1 = OrbFrontend(_cfg()).extract(img)
    f2 = OrbFrontend(_cfg()).extract(img)
    for a, b in zip(jax.tree.leaves(f1), jax.tree.leaves(f2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adaptive_threshold_converges_count():
    cfg = _cfg(adaptive_threshold=True, target_fill=0.5, threshold=0.01)
    fe = OrbFrontend(cfg)
    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.random((96, 128)).astype(np.float32))
    for _ in range(25):
        f = fe.extract(img)
    fill = int(f.count) / f.capacity
    assert 0.2 < fill <= 1.0, fill


def test_dot_grid_corners_on_grid():
    cfg = _cfg(num_levels=1, nms=True)
    fe = OrbFrontend(cfg)
    img = jnp.asarray(dot_grid(96, 128, spacing=12, offset=24))
    feats = fe.extract(img)
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    assert len(xy) > 10
    # Dots are centered at offset + k*spacing; detections within +/-2 px.
    offs = np.minimum((xy - 24) % 12, 12 - ((xy - 24) % 12))
    assert np.all(offs <= 2.0)


def test_rgb_input_and_threshold_override():
    cfg = _cfg()
    fe = OrbFrontend(cfg)
    rng = np.random.default_rng(10)
    rgb = jnp.asarray(rng.random((96, 128, 3)).astype(np.float32))
    f_low = fe.extract(rgb, threshold=0.02)
    f_high = fe.extract(rgb, threshold=0.4)
    assert int(f_low.count) >= int(f_high.count)


def test_rgba_input_matches_rgb():
    # The reference ingests Rgba8Unorm frames (reference src/orb.rs:116-121);
    # alpha must be dropped, not folded into luma.
    cfg = _cfg(adaptive_threshold=False)
    fe = OrbFrontend(cfg)
    rng = np.random.default_rng(12)
    rgb = rng.random((96, 128, 3)).astype(np.float32)
    rgba = np.concatenate([rgb, np.full((96, 128, 1), 0.5, np.float32)], -1)
    f3 = fe.extract(jnp.asarray(rgb))
    f4 = fe.extract(jnp.asarray(rgba))
    for a, b in zip(jax.tree.leaves(f3), jax.tree.leaves(f4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # uint8 RGBA also accepted (the reference's actual upload format).
    f8 = fe.extract(jnp.asarray((rgba * 255).astype(np.uint8)))
    assert int(f8.count) > 0


def test_adaptive_threshold_stays_on_device():
    # The controller must never materialize feats.count on the host: the
    # threshold state is a device array end to end.
    cfg = _cfg(adaptive_threshold=True)
    fe = OrbFrontend(cfg)
    rng = np.random.default_rng(13)
    img = jnp.asarray(rng.random((96, 128)).astype(np.float32))
    fe.extract(img)
    assert isinstance(fe._threshold, jax.Array)


def test_levels_report_level0_coords():
    cfg = _cfg(num_levels=3)
    fe = OrbFrontend(cfg)
    img = jnp.asarray(dot_grid(96, 128, spacing=16, offset=24))
    feats = fe.extract(img)
    lv = np.asarray(feats.level)
    v = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)
    # At least level 0 fires; all valid coords inside the level-0 frame.
    assert (lv[v] == 0).any()
    assert xy[v, 0].max() < 128 and xy[v, 1].max() < 96
