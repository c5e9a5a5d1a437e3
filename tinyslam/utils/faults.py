"""Failure detection, snapshotting and elastic recovery (SURVEY §5).

The reference has no error paths at all: a hung device blocks forever
(reference src/orb.rs:547 device.poll(Wait)) and every fallible call is
unwrapped (orb.rs:553).  This framework treats faults as first-class:

- ``Watchdog`` supervises the async back-end worker (parallel/pipeline.py):
  a dead worker thread or a solve exceeding its deadline is detected at the
  next frame boundary and the worker is rebuilt (the abandoned thread is a
  daemon; its late result is discarded with its object).  Drop-in for
  ``AsyncWorker`` — same submit/poll/flush/close surface.
- ``SnapshotPolicy`` checkpoints the tracker every N keyframes (Orbax via
  utils/checkpoint) and keeps a bounded history; ``restore_latest`` brings a
  fresh instance back to the newest intact snapshot.  Recovery after restart
  is the tracker's normal lost-recovery path: global matching + PnP-RANSAC
  relocalization against the restored map.
- ``Heartbeat`` detects a hung/partitioned device or peer: a tiny collective
  (or device op) is dispatched on a side thread with a deadline; a missed
  deadline reports dead instead of blocking the caller forever.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from tinyslam.parallel.pipeline import AsyncWorker


class Watchdog:
    """Supervised AsyncWorker with deadline + liveness checks.

    check() (called by the tracker at frame boundaries, or any time) probes:
      - liveness: the worker thread is alive;
      - progress: the running job has not exceeded ``solve_timeout_s``.
    On failure the worker is replaced; the interrupted job is resubmitted
    once (``resubmit=True``) so a crashed solve is retried, not lost.
    """

    def __init__(self, solve_timeout_s: float = 30.0, resubmit: bool = True,
                 name: str = "tinyslam-backend"):
        self.solve_timeout_s = solve_timeout_s
        self.resubmit = resubmit
        self._name = name
        self.worker = AsyncWorker(name)
        self.restarts = 0
        self._last_fn: Optional[Callable[[], Any]] = None
        self._submitted_at: float = 0.0
        self._lock = threading.Lock()

    # ---- AsyncWorker surface ----
    def submit(self, fn: Callable[[], Any]) -> None:
        with self._lock:
            self._last_fn = fn
            self._submitted_at = time.monotonic()
            self.worker.submit(fn)

    def poll(self):
        self.check()
        return self.worker.poll()

    def flush(self):
        # A flush on a hung worker would block forever — bound it by the
        # deadline and restart instead.
        deadline = time.monotonic() + self.solve_timeout_s
        while self.worker.busy:
            if time.monotonic() > deadline:
                self.check(force_stuck=True)
                break
            time.sleep(0.005)
            if not self.worker._thread.is_alive():
                break
        self.check()
        return self.worker.poll()

    def close(self):
        self.worker.close()

    @property
    def busy(self) -> bool:
        return self.worker.busy

    # ---- supervision ----
    def check(self, force_stuck: bool = False) -> str:
        """Probe worker health; rebuild on fault.  Returns 'ok', 'restarted-dead'
        or 'restarted-stuck'."""
        with self._lock:
            dead = not self.worker._thread.is_alive()
            stuck = force_stuck or (
                self.worker.busy
                and self._submitted_at > 0
                and time.monotonic() - self._submitted_at > self.solve_timeout_s
            )
            if not dead and not stuck:
                return "ok"
            # Abandon the old worker (daemon thread; late results dropped
            # with the object) and rebuild.
            try:
                self.worker._closed = True  # stop loop w/o joining a hung thread
                with self.worker._cond:
                    self.worker._cond.notify_all()
            except Exception:
                pass
            self.worker = AsyncWorker(self._name)
            self.restarts += 1
            kind = "restarted-dead" if dead else "restarted-stuck"
            if self.resubmit and self._last_fn is not None:
                self._submitted_at = time.monotonic()
                self.worker.submit(self._last_fn)
            return kind


class SnapshotPolicy:
    """Periodic checkpoint-on-keyframe policy with bounded history.

    maybe_snapshot(system) checkpoints when ``num_keyframes`` has advanced by
    ``every_keyframes`` since the last snapshot; the newest ``keep`` snapshots
    are retained.  Works for VisualOdometry and Slam (utils/checkpoint
    save_vo / save_slam).
    """

    def __init__(self, directory, every_keyframes: int = 5, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = every_keyframes
        self.keep = keep
        self._last_kf = 0

    def _save(self, system, path: Path) -> None:
        from tinyslam.utils.checkpoint import save_slam, save_vo

        if hasattr(system, "vo"):          # Slam
            save_slam(system, path)
        else:
            save_vo(system, path)

    def maybe_snapshot(self, system) -> Optional[Path]:
        vo = getattr(system, "vo", system)
        if vo.num_keyframes - self._last_kf < self.every:
            return None
        self._last_kf = vo.num_keyframes
        path = self.dir / f"snap_{vo.num_keyframes:06d}"
        self._save(system, path)
        snaps = self.snapshots()
        for old in snaps[: -self.keep]:
            import shutil

            shutil.rmtree(old, ignore_errors=True)
        return path

    def snapshots(self) -> list[Path]:
        return sorted(p for p in self.dir.glob("snap_*") if p.is_dir())

    def restore_latest(self, system) -> Optional[Path]:
        """Restore the newest intact snapshot into a fresh instance; corrupt
        snapshots (e.g. a crash mid-save) are skipped, newest first."""
        from tinyslam.utils.checkpoint import restore_slam, restore_vo

        for path in reversed(self.snapshots()):
            try:
                if hasattr(system, "vo"):
                    restore_slam(system, path)
                else:
                    restore_vo(system, path)
                # Crash-recovery semantics: the world moved on between the
                # snapshot and the crash, so the restored pose is stale —
                # force global relocalization (PnP-RANSAC with the stale
                # pose as one prior hypothesis) on the first frame instead
                # of the guided path's trust in a fresh prediction.
                getattr(system, "vo", system).force_reloc = True
                return path
            except Exception:
                continue
        return None


class Heartbeat:
    """Deadline-bounded device/cluster liveness probe.

    ``beat()`` dispatches ``probe_fn`` (default: a trivial jitted device op;
    pass a psum over the mesh for multi-host) on a side thread and waits at
    most ``timeout_s``.  Returns True if the device answered.  A hung device
    — the reference's unrecoverable state (orb.rs:547) — reports False
    instead of blocking the control loop.
    """

    def __init__(self, probe_fn: Optional[Callable[[], Any]] = None,
                 timeout_s: float = 5.0):
        if probe_fn is None:
            def probe_fn():
                import jax
                import jax.numpy as jnp

                return float(jax.jit(lambda x: x + 1)(jnp.float32(0.0)))

        self._probe = probe_fn
        self.timeout_s = timeout_s
        self.missed = 0

    def beat(self) -> bool:
        ok = threading.Event()

        def _run():
            try:
                self._probe()
                ok.set()
            except Exception:
                pass

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        alive = ok.wait(self.timeout_s)
        if not alive:
            self.missed += 1
        else:
            self.missed = 0
        return alive
