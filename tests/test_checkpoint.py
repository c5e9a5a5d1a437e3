"""Checkpoint/resume: save a mid-sequence VO state, restore into a fresh
instance, continue tracking identically (SURVEY §5 failure-recovery
primitive; the fault-injection test kills the first instance outright)."""

import numpy as np
import pytest

from tinyslam.config import BAConfig, FrontendConfig, SlamConfig, VOConfig
from tinyslam.data.synthetic import vo_sequence
from tinyslam.models.vo import VisualOdometry
from tinyslam.utils.checkpoint import restore_vo, save_vo


def _cfg():
    return SlamConfig(
        frontend=FrontendConfig(height=240, width=320, num_levels=2,
                                features_per_level=256, threshold=0.08,
                                interpolate_descriptors=True),
        vo=VOConfig(max_map_points=2048, keyframe_min_inliers=80,
                    keyframe_max_interval=5),
        ba=BAConfig(max_keyframes=8, max_iters=6),
    )


@pytest.fixture(scope="module")
def sequence():
    rng = np.random.default_rng(7)
    return vo_sequence(rng, num_frames=24)


@pytest.mark.slow
def test_checkpoint_resume_continues_identically(tmp_path, sequence):
    cam, images, gt_poses, _ = sequence
    vo = VisualOdometry(_cfg(), cam)
    for im in images[:14]:
        vo.process(im)
    assert vo.initialized

    save_vo(vo, tmp_path / "ckpt")

    # Simulate a crash: fresh process state, restore, continue.
    vo2 = VisualOdometry(_cfg(), cam)
    restore_vo(vo2, tmp_path / "ckpt")
    assert vo2.initialized
    assert int(np.sum(np.asarray(vo2.map.valid))) == int(
        np.sum(np.asarray(vo.map.valid))
    )

    for im in images[14:]:
        a = vo.process(im)
        b = vo2.process(im)
        assert a.tracking == b.tracking
    np.testing.assert_allclose(vo.positions, vo2.positions, atol=1e-5)


def test_device_vo_state_round_trip(tmp_path):
    """Fast save/restore of a DeviceVO's device state (no tracking): every
    VOState leaf and the host bookkeeping come back exactly."""
    import jax
    import jax.numpy as jnp

    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models.vo import VOStats
    from tinyslam.models.vo_device import DeviceVO, VOState
    from tinyslam.utils.checkpoint import restore_device_vo, save_device_vo

    cfg = _cfg()
    cam = PinholeCamera.create(200.0, 200.0, 160.0, 120.0)
    rng = np.random.default_rng(3)
    state = VOState.empty(cfg)
    state = jax.tree.map(
        lambda x: jnp.asarray(
            rng.integers(0, 2, x.shape).astype(x.dtype)
            if x.dtype == bool else
            rng.integers(0, 1000, x.shape).astype(x.dtype)), state)
    dvo = DeviceVO(cfg, cam, chunk=4)
    dvo.state = state
    dvo._frame_idx = 41
    dvo.trajectory = [(np.eye(3, dtype=np.float32), np.ones(3, np.float32))]
    dvo.stats = [VOStats(frame=0, num_features=5, num_matches=4,
                         num_inliers=3, num_landmarks=2, is_keyframe=True,
                         tracking=True, rmse_px=0.5)]
    save_device_vo(dvo, tmp_path / "ckpt")

    dvo2 = DeviceVO(cfg, cam, chunk=4)
    restore_device_vo(dvo2, tmp_path / "ckpt")
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(dvo2.state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert dvo2._frame_idx == 41
    assert dvo2.stats == dvo.stats
    np.testing.assert_array_equal(dvo2.trajectory[0][1], np.ones(3))


@pytest.mark.parametrize("old_version", [None, 2])
def test_older_checkpoint_format_is_refused(tmp_path, old_version):
    """A checkpoint of an older format (v1 unversioned, v2 in the former
    directory layout) fails with the version error, not a missing-file or
    key error."""
    import json

    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models.vo_device import DeviceVO
    from tinyslam.utils.checkpoint import restore_device_vo

    meta = {"device": True, "frame_idx": 3}
    if old_version is not None:
        meta["format_version"] = old_version
    (tmp_path / "device_meta.json").write_text(json.dumps(meta))
    dvo = DeviceVO(_cfg(), PinholeCamera.create(200.0, 200.0, 160.0, 120.0))
    with pytest.raises(ValueError, match="incompatible checkpoint format"):
        restore_device_vo(dvo, tmp_path)
