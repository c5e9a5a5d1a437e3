"""Failure detection + fault injection (SURVEY §5): watchdog restarts on a
killed/hung back-end worker, snapshot/restore recovery mid-sequence, and a
deadline-bounded heartbeat on a hung device probe."""

import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest

from tinyslam.utils.faults import Heartbeat, SnapshotPolicy, Watchdog


def test_watchdog_restarts_dead_worker():
    w = Watchdog(solve_timeout_s=5.0)
    done = []
    w.submit(lambda: done.append(1) or "a")
    assert w.flush() == "a"
    # Fault injection: kill the worker thread (simulates a crashed backend).
    w.worker.close()
    assert not w.worker._thread.is_alive()
    assert w.check() == "restarted-dead"
    assert w.restarts == 1
    # The replacement worker is live and the last job was resubmitted.
    assert w.flush() == "a"
    w.submit(lambda: "b")
    assert w.flush() == "b"
    w.close()


def test_watchdog_restarts_stuck_worker():
    w = Watchdog(solve_timeout_s=0.2, resubmit=False)
    release = threading.Event()
    w.submit(lambda: release.wait(10.0))   # a solve that blocks past deadline
    time.sleep(0.4)
    assert w.check() == "restarted-stuck"
    assert w.restarts == 1
    w.submit(lambda: "ok")
    assert w.flush() == "ok"
    release.set()                           # unblock the abandoned thread
    w.close()


def test_watchdog_flush_bounded_on_hung_worker():
    w = Watchdog(solve_timeout_s=0.3, resubmit=False)
    release = threading.Event()
    w.submit(lambda: release.wait(10.0))
    t0 = time.monotonic()
    out = w.flush()                         # must NOT block forever
    assert time.monotonic() - t0 < 5.0
    assert out is None
    assert w.restarts == 1
    release.set()
    w.close()


def test_heartbeat_device_and_hang():
    hb = Heartbeat(timeout_s=5.0)
    assert hb.beat()                        # real device op answers
    assert hb.missed == 0
    hung = Heartbeat(probe_fn=lambda: time.sleep(60), timeout_s=0.2)
    assert not hung.beat()
    assert hung.missed == 1


def _mini_scene(n_frames: int):
    from tinyslam.data.synthetic import vo_sequence

    rng = np.random.default_rng(21)
    return vo_sequence(rng, num_frames=n_frames, width=320, height=240)


@pytest.mark.slow
def test_snapshot_crash_restore_resumes_tracking(tmp_path):
    """Kill the tracker mid-sequence; a fresh instance restored from the last
    periodic snapshot must re-localize against the restored map and keep
    tracking the remaining frames."""
    from tinyslam.config import SlamConfig
    from tinyslam.models import VisualOdometry

    cam, images, poses, _ = _mini_scene(46)
    cfg = SlamConfig()
    policy = SnapshotPolicy(tmp_path, every_keyframes=1, keep=2)

    vo = VisualOdometry(cfg, cam)
    crash_at = 30
    for i in range(crash_at):
        vo.process(jnp.asarray(images[i]))
        policy.maybe_snapshot(vo)
    assert policy.snapshots(), "no snapshot was taken before the crash"
    # The newest snapshot must be recent enough that its map still overlaps
    # the crash-point viewpoint (a recovery system snapshots continuously).
    assert vo.num_keyframes >= 3
    del vo                                   # "crash"

    vo2 = VisualOdometry(cfg, cam)
    restored = policy.restore_latest(vo2)
    assert restored is not None
    assert vo2.initialized
    n_restored = len(vo2.trajectory)
    # Resume from the crash point: the pose is stale (frames advanced since
    # the snapshot), so the first frames exercise the relocalization path.
    tracked = 0
    for i in range(crash_at, len(images)):
        st = vo2.process(jnp.asarray(images[i]))
        tracked += int(st.tracking)
    assert tracked >= (len(images) - crash_at) - 3, (
        f"tracking did not resume after restore: {tracked}")
    assert len(vo2.trajectory) == n_restored + (len(images) - crash_at)


@pytest.mark.slow
def test_slam_snapshot_roundtrip(tmp_path):
    """save_slam/restore_slam round-trips the loop-closure layer."""
    from tinyslam.config import SlamConfig
    from tinyslam.models import Slam
    from tinyslam.utils.checkpoint import restore_slam, save_slam

    cam, images, poses, _ = _mini_scene(30)
    cfg = SlamConfig()
    slam = Slam(cfg, cam)
    for im in images:
        slam.process_frame(jnp.asarray(im))
    save_slam(slam, tmp_path / "ck")

    slam2 = Slam(cfg, cam)
    restore_slam(slam2, tmp_path / "ck")
    assert len(slam2.kf_store) == len(slam.kf_store)
    assert len(slam2.edges) == len(slam.edges)
    assert slam2.num_loop_closures == slam.num_loop_closures
    np.testing.assert_allclose(
        np.stack(slam2.kf_R), np.stack(slam.kf_R), atol=1e-6)
    for a, b in zip(slam2.kf_signatures, slam.kf_signatures):
        np.testing.assert_allclose(a, b, atol=1e-6)
    # The restored instance keeps working.
    st = slam2.process_frame(jnp.asarray(images[-1]))
    assert st is not None
