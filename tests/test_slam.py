"""Full SLAM with loop closure on an out-and-back synthetic sequence
(BASELINE config 5 analog, single host)."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from tinyslam.config import (
    BAConfig,
    FrontendConfig,
    PoseGraphConfig,
    SlamConfig,
    VOConfig,
)
from tinyslam.data.synthetic import vo_sequence
from tinyslam.models.slam import Slam
from tinyslam.utils.evaluation import ate_rmse


def _cfg():
    return SlamConfig(
        frontend=FrontendConfig(height=240, width=320, num_levels=2,
                                features_per_level=256, threshold=0.08,
                                interpolate_descriptors=True),
        vo=VOConfig(max_map_points=4096, keyframe_min_inliers=80,
                    keyframe_max_interval=5),
        ba=BAConfig(max_keyframes=8, max_iters=6),
        pose_graph=PoseGraphConfig(loop_min_gap=6, loop_min_matches=40,
                                   gn_iters=10),
    )


@pytest.fixture(scope="module")
def out_and_back():
    rng = np.random.default_rng(7)
    cam, images, poses, room = vo_sequence(rng, num_frames=36)
    # Return to start: traverse the same viewpoints backwards (revisits
    # earlier scenery -> place recognition must fire).
    images2 = images + images[-2:0:-1]
    poses2 = poses + poses[-2:0:-1]
    return cam, images2, poses2


def test_slam_runs_and_closes_loops(out_and_back):
    cam, images, gt_poses = out_and_back
    slam = Slam(_cfg(), cam)
    slam.run(images)
    assert slam.vo.initialized
    ntrk = sum(1 for s in slam.vo.stats if s.tracking)
    assert ntrk > 0.7 * len(images), f"tracked {ntrk}/{len(images)}"
    # The return leg revisits mapped territory: at least one loop closure.
    assert slam.num_loop_closures >= 1
    gt_pos = np.stack([-(R.T @ t) for R, t in gt_poses])
    first = next(i for i, s in enumerate(slam.vo.stats) if s.tracking)
    ate = ate_rmse(slam.positions[first:], gt_pos[first:])
    assert ate < 0.6, f"ATE {ate:.3f}"


def test_slam_edges_and_nodes_consistent(out_and_back):
    cam, images, _ = out_and_back
    slam = Slam(_cfg(), cam)
    slam.run(images[:20])
    n = len(slam.kf_R)
    assert n == slam.vo.num_keyframes == len(slam.kf_store)
    for i, j, _, _, s, w in slam.edges:
        assert 0 <= i < n and 0 <= j < n and w > 0 and s > 0


def test_slam_async_backend_matches_sync(out_and_back):
    """Async (PP-analog, parallel/pipeline.py) loop closure: tracking never
    blocks on the pose-graph solve; the end-state trajectory quality must
    match the synchronous path."""
    cam, images, gt_poses = out_and_back
    slam = Slam(_cfg(), cam, async_backend=True)
    try:
        slam.run(images)
        assert slam.num_loop_closures >= 1
        ntrk = sum(1 for s in slam.vo.stats if s.tracking)
        assert ntrk > 0.7 * len(images)
        gt_pos = np.stack([-(R.T @ t) for R, t in gt_poses])
        first = next(i for i, s in enumerate(slam.vo.stats) if s.tracking)
        ate = ate_rmse(slam.positions[first:], gt_pos[first:])
        assert ate < 0.6, f"ATE {ate:.3f}"
    finally:
        slam.close()


def test_device_slam_runs_and_closes_loops(out_and_back):
    """DeviceSlam: the same loop-closure layer over the chunked device
    tracker — keyframes sync from VOState.win_feats at chunk boundaries,
    corrections apply functionally to the device state."""
    from tinyslam.models.slam import DeviceSlam

    cam, images, gt_poses = out_and_back
    slam = DeviceSlam(_cfg(), cam, chunk=8)
    slam.run(images)
    assert slam.vo.initialized
    ntrk = sum(1 for s in slam.vo.stats if s.tracking)
    assert ntrk > 0.7 * len(images), f"tracked {ntrk}/{len(images)}"
    assert slam.num_loop_closures >= 1
    # Keyframe bookkeeping is consistent across the device/host boundary.
    n = len(slam.kf_R)
    assert n == slam.vo.num_keyframes == len(slam.kf_store)
    for i, j, _, _, s, w in slam.edges:
        assert 0 <= i < n and 0 <= j < n and w > 0 and s > 0
    gt_pos = np.stack([-(R.T @ t) for R, t in gt_poses])
    first = next(i for i, s in enumerate(slam.vo.stats) if s.tracking)
    ate = ate_rmse(slam.positions[first:], gt_pos[first:])
    assert ate < 0.6, f"ATE {ate:.3f}"


def test_async_worker_latest_wins():
    import time

    from tinyslam.parallel.pipeline import AsyncWorker

    w = AsyncWorker()
    try:
        done = []

        def slow(tag):
            def fn():
                time.sleep(0.2)
                done.append(tag)
                return tag
            return fn

        w.submit(slow("a"))
        time.sleep(0.05)          # "a" started
        w.submit(slow("b"))
        w.submit(slow("c"))       # replaces "b" before it starts
        assert w.flush() == "c"
        assert "b" not in done
    finally:
        w.close()


def test_async_worker_propagates_errors():
    from tinyslam.parallel.pipeline import AsyncWorker

    w = AsyncWorker()
    try:
        def boom():
            raise ValueError("backend failure")

        w.submit(boom)
        import pytest as _pytest
        with _pytest.raises(ValueError, match="backend failure"):
            w.flush()
    finally:
        w.close()


def test_device_slam_keyframe_churn_keeps_features(out_and_back):
    """VERDICT r3 weak #5 / next-step #7: with a keyframe every frame and
    chunk=16, most keyframes roll out of the 8-slot BA window before the
    host ever syncs them — their features must survive via the device
    keyframe ring (VOState.kf_ring) so they can still seed loop closures."""
    from tinyslam.models.slam import DeviceSlam

    cam, images, gt_poses = out_and_back
    base = _cfg()
    cfg = base.replace(vo=base.vo.replace(
        keyframe_max_interval=1, keyframe_min_interval=1,
        keyframe_min_inliers=10_000))        # force a keyframe every frame
    slam = DeviceSlam(cfg, cam, chunk=16)
    slam.run(images)
    assert slam.vo.initialized
    # Many more keyframes than window slots: churn actually happened.
    assert len(slam.kf_store) > 3 * cfg.ba.max_keyframes
    # Every synced keyframe kept real features (no empty fallbacks).
    counts = [int(f.count) for f in slam.kf_store]
    assert min(counts) > 0, f"empty keyframe features: {counts}"
    # And the return leg still closes a loop seeded by rolled-out keyframes.
    assert slam.num_loop_closures >= 1
