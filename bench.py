"""Headline benchmark on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Headline: TRACKED frames/s on one chip — the BASELINE.json north star
(floor: >= 200 tracked fps/chip).  Measured by driving the flagship
device-resident tracker (models/vo_device.py track_chunk: extraction,
guided matching, PnP, keyframe insertion + windowed BA under lax.cond, all
in one lax.scan dispatch per chunk) over rendered 640x480 frames of a
textured-room sequence, post-bootstrap.  Secondary: front-end-only fps
(the previous headline, BASELINE config 1).

Methodology notes:
- chunks are dispatched back-to-back and synchronized once at the end of
  each round (jax.block_until_ready) — DeviceVO's production dispatch
  pattern;
- the fraction of timed frames actually TRACKED is reported; a tracked-fps
  number where tracking collapsed would be meaningless;
- the persistent XLA compilation cache is enabled (utils/cache.py) and
  every shape is warmed up first, so the reported numbers are compute, not
  compile;
- the line names the device it ran on; there is no CPU fallback.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _render_room_sequence(n_frames: int, width: int = 640, height: int = 480):
    """Rendered 640x480 frames orbiting a textured room (true 3D corners,
    perspective-correct — the same generator the accuracy eval uses)."""
    from tinyslam.data.synthetic import (
        TexturedRoom,
        orbit_trajectory,
    )
    from tinyslam.geometry.camera import PinholeCamera

    rng = np.random.default_rng(3)
    cam = PinholeCamera.create(
        fx=520.0, fy=520.0, cx=width / 2 - 0.5, cy=height / 2 - 0.5)
    room = TexturedRoom(rng, tex_res=64, octaves=2)
    poses = orbit_trajectory(n_frames, radius=2.0, step=0.02,
                             start=-0.35, target=(0.0, 0.0, 2.0))
    frames = [room.render(cam, R, t, width, height) for R, t in poses]
    return cam, frames


def _render_eval_grade_sequence(n_frames: int, width: int = 640,
                                height: int = 480):
    """Eval-grade frames: real fr1 intrinsics + radtan lens distortion,
    handheld 6-DoF motion, vignetting, auto-exposure hunting, sensor noise,
    8-bit quantization — the tools/eval_ate.py renderer (a tracked-fps
    claim should survive eval-grade rendering).  Frames are
    undistorted through the production Undistorter, as the TUM loader does."""
    from tinyslam.data.synthetic import (
        TexturedRoom, handheld_trajectory, render_sequence,
    )
    from tinyslam.data.tum import FR1_DIST, FR1_INTRINSICS
    from tinyslam.data.undistort import Undistorter
    from tinyslam.geometry.camera import PinholeCamera

    rng = np.random.default_rng(101)
    room = TexturedRoom(rng, tex_res=128, octaves=3, clutter=8)
    cam = PinholeCamera.create(**FR1_INTRINSICS)
    poses = handheld_trajectory(rng, n_frames)
    frames = render_sequence(rng, poses, cam, width, height, room,
                             dist=FR1_DIST)
    und = Undistorter(FR1_INTRINSICS, FR1_DIST, height=height, width=width)
    return cam, [und(f) for f in frames]


def bench_tracked(chunk: int = 32, chunks_timed: int = 4,
                  rounds: int = 3, eval_grade: bool = False) -> dict:
    import jax
    import jax.numpy as jnp

    from tinyslam.config import SlamConfig
    from tinyslam.models.vo_device import DeviceVO, track_chunk

    cfg = SlamConfig()
    n_total = 14 + chunk * (chunks_timed + 1)
    render = (_render_eval_grade_sequence if eval_grade
              else _render_room_sequence)
    cam, frames = render(n_total, cfg.frontend.width, cfg.frontend.height)

    # Bootstrap on the host path (two-view init), then lift to VOState.
    vo = DeviceVO(cfg, cam, chunk=chunk)
    i = 0
    while not vo.initialized and i < len(frames):
        vo.process(jnp.asarray(frames[i]))
        i += 1
    assert vo.initialized, "bootstrap failed on the bench sequence"
    state = vo.state
    active = jnp.ones((chunk,), bool)

    def mk(j):
        return jnp.asarray(np.stack(frames[j:j + chunk]))

    # Warm-up chunk: pays compile (or loads the persistent cache).
    state, ys = track_chunk(cam, cfg, state, mk(i), active)
    jax.block_until_ready(ys)
    i += chunk

    chunk_imgs = []
    while i + chunk <= len(frames) and len(chunk_imgs) < chunks_timed:
        chunk_imgs.append(mk(i))
        i += chunk

    per_round = []
    tracked = total = 0
    for r in range(rounds):
        st = state
        t0 = time.perf_counter()
        outs = []
        for imgs in chunk_imgs:
            st, ys = track_chunk(cam, cfg, st, imgs, active)
            outs.append(ys)
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        n = chunk * len(chunk_imgs)
        per_round.append(n / dt)
        for ys in outs:
            s = np.asarray(ys["summary"])
            tracked += int(s[:, 3].sum())
            total += len(s)
    return {
        "tracked_fps": float(np.median(per_round)),
        "tracked_frac": tracked / max(total, 1),
        "frames_timed": total,
    }


def bench_frontend(rounds: int = 4) -> float:
    """Front-end-only frames/s (extraction of 16 distinct frames per round)."""
    import jax
    import jax.numpy as jnp

    from tinyslam.config import FrontendConfig
    from tinyslam.frontend.orb import extract_features

    cfg = FrontendConfig()
    rng = np.random.default_rng(0)
    frames = [jnp.asarray(rng.random((480, 640), np.float32))
              for _ in range(16)]
    t = jnp.float32(cfg.threshold)
    f = jax.jit(lambda im, t: extract_features(im, t, cfg))
    jax.block_until_ready(f(frames[0], t))
    per_round = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready([f(im, t) for im in frames])
        per_round.append(len(frames) / (time.perf_counter() - t0))
    return float(np.median(per_round))


def main():
    import jax

    from tinyslam.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; found {dev.platform}")
    enable_compilation_cache()
    tr = bench_tracked()
    ev = bench_tracked(eval_grade=True)
    fe = bench_frontend()
    fps = tr["tracked_fps"]
    line = {
        "metric": "tracked_frames_per_s_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 200.0, 3),
        "tracked_frac": round(tr["tracked_frac"], 3),
        # Same tracker on eval-grade rendering (distortion + photometric
        # effects + undistortion resampling): the honest-conditions row.
        "eval_grade_fps": round(ev["tracked_fps"], 1),
        "eval_grade_tracked_frac": round(ev["tracked_frac"], 3),
        "frontend_fps": round(fe, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
