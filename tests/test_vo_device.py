"""Device-resident VO (models/vo_device.py): the chunked lax.scan tracker
must track the same synthetic sequences as the host-driven loop, with the
same accuracy, from a single dispatch per chunk."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from tinyslam.config import (
    BAConfig,
    FrontendConfig,
    SlamConfig,
    VOConfig,
)
from tinyslam.data.synthetic import vo_sequence
from tinyslam.models.vo import VisualOdometry
from tinyslam.models.vo_device import DeviceVO
from tinyslam.utils.evaluation import ate_rmse


def _small_cfg():
    return SlamConfig(
        frontend=FrontendConfig(
            height=240, width=320, num_levels=2, features_per_level=256,
            threshold=0.08,
        ),
        vo=VOConfig(max_map_points=2048, keyframe_min_inliers=50,
                    keyframe_max_interval=8),
        ba=BAConfig(max_keyframes=6, max_iters=6),
    )


@pytest.fixture(scope="module")
def sequence():
    rng = np.random.default_rng(7)
    return vo_sequence(rng, num_frames=40, num_points=400)


def test_device_vo_tracks(sequence):
    cam, images, gt_poses, _ = sequence
    vo = DeviceVO(_small_cfg(), cam, chunk=8)
    stats = vo.run(images)

    assert vo.initialized, "bootstrap failed"
    tracked = [s for s in stats if s.tracking]
    assert len(tracked) > 0.75 * len(images), f"tracked {len(tracked)}"

    gt_pos = np.stack([-(R.T @ t) for R, t in gt_poses])
    est_pos = vo.positions
    first = next(i for i, s in enumerate(stats) if s.tracking)
    ate = ate_rmse(est_pos[first:], gt_pos[first:], with_scale=True)
    assert ate < 0.5, f"ATE {ate:.4f} m"


def test_device_vo_matches_host_quality(sequence):
    """Same decisions, moved from host ifs to lax.cond: accuracy must match
    the host loop closely on the same sequence."""
    cam, images, gt_poses, _ = sequence
    gt_pos = np.stack([-(R.T @ t) for R, t in gt_poses])

    host = VisualOdometry(_small_cfg(), cam)
    host.run(images)
    first_h = next(i for i, s in enumerate(host.stats) if s.tracking)
    ate_host = ate_rmse(host.positions[first_h:], gt_pos[first_h:],
                        with_scale=True)

    dev = DeviceVO(_small_cfg(), cam, chunk=8)
    dev.run(images)
    first_d = next(i for i, s in enumerate(dev.stats) if s.tracking)
    ate_dev = ate_rmse(dev.positions[first_d:], gt_pos[first_d:],
                       with_scale=True)

    assert ate_dev < max(2.0 * ate_host, 0.15), (
        f"device ATE {ate_dev:.4f} vs host {ate_host:.4f}")


def test_device_vo_checkpoint_crash_restore(tmp_path, sequence):
    """Kill a DeviceVO mid-sequence; a fresh instance restored from the last
    periodic snapshot (the whole VOState is one Orbax pytree) must
    relocalize against the restored device-resident map and keep tracking
    (VERDICT r2 item 4: the flagship tracker must be checkpointable)."""
    from tinyslam.utils.faults import SnapshotPolicy

    cam, images, _, _ = sequence
    tmp = tmp_path / "snaps"
    policy = SnapshotPolicy(tmp, every_keyframes=1, keep=2)
    vo = DeviceVO(_small_cfg(), cam, chunk=8)
    crash_at = 28
    for im in images[:crash_at]:
        vo.process(im)
        policy.maybe_snapshot(vo)
    vo.flush()
    n_kf = vo.num_keyframes
    assert policy.snapshots(), "no snapshot before the crash"
    del vo

    vo2 = DeviceVO(_small_cfg(), cam, chunk=8)
    assert policy.restore_latest(vo2) is not None
    assert vo2.initialized
    # The snapshot may predate keyframes created by the final (flushed)
    # chunk; it must still hold a usable map from >= 3 keyframes.
    assert 3 <= vo2.num_keyframes <= n_kf
    assert vo2.force_reloc            # crash-recovery reloc armed
    for im in images[crash_at:]:
        vo2.process(im)
    vo2.flush()
    post = vo2.stats[crash_at:]
    tracked = sum(1 for s in post if s.tracking)
    assert tracked >= len(post) - 3, f"only {tracked}/{len(post)} re-tracked"


def test_device_vo_partial_chunk(sequence):
    """flush() with a partial buffer must produce identical results to a
    chunk-aligned run (inactive steps are identity on the carry)."""
    cam, images, _, _ = sequence
    a = DeviceVO(_small_cfg(), cam, chunk=8)
    a.run(images[:30])          # 30 frames: bootstrap prefix + partial chunk
    b = DeviceVO(_small_cfg(), cam, chunk=5)
    b.run(images[:30])
    pa, pb = a.positions, b.positions
    assert pa.shape == pb.shape
    np.testing.assert_allclose(pa, pb, atol=2e-2)
