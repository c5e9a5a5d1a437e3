"""CLI entry point: run VO/SLAM over a dataset sequence.

    python -m tinyslam.run --dataset tum --root /data/fr1_desk \\
        --config my_config.json --output traj.txt --metrics metrics.json

The reference has no binary/CLI at all (SURVEY header); this is the
``--config``-override runner prescribed in SURVEY §5 (config system).
Works with TUM RGB-D, EuRoC ASL, or the built-in synthetic room sequence
(--dataset synthetic, no files needed).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=["tum", "euroc", "synthetic"],
                    default="synthetic")
    ap.add_argument("--root", help="sequence directory (tum/euroc)")
    ap.add_argument("--config", help="SlamConfig JSON file")
    ap.add_argument("--mode", choices=["vo", "slam"], default="slam")
    ap.add_argument("--tracker", choices=["device", "host"], default="device",
                    help="device = chunked lax.scan tracker (one readback "
                         "per chunk, the flagship path); host = per-frame "
                         "host-decision loop (debug/reference)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per device dispatch (device tracker)")
    ap.add_argument("--frames", type=int, default=0, help="limit frame count")
    ap.add_argument("--output", help="trajectory output (TUM format)")
    ap.add_argument("--metrics", help="metrics JSON output")
    ap.add_argument("--summary", help="run summary JSON output (frames, "
                    "tracked fraction, keyframes, ATE, wall time)")
    ap.add_argument("--fx", type=float)
    ap.add_argument("--fy", type=float)
    ap.add_argument("--cx", type=float)
    ap.add_argument("--cy", type=float)
    args = ap.parse_args(argv)

    import numpy as np
    import jax.numpy as jnp

    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from tinyslam.config import SlamConfig
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models import DeviceSlam, DeviceVO, Slam, VisualOdometry
    from tinyslam.utils.evaluation import ate_rmse
    from tinyslam.utils.metrics import Metrics

    cfg = SlamConfig()
    if args.config:
        cfg = SlamConfig.from_json(open(args.config).read())

    gt_positions = None
    timestamps = []
    if args.dataset == "synthetic":
        from tinyslam.data.synthetic import vo_sequence

        rng = np.random.default_rng(7)
        n = args.frames or 60
        cam, frames_np, gt_poses, _ = vo_sequence(
            rng, num_frames=n,
            width=cfg.frontend.width if cfg.frontend.width <= 320 else 320,
            height=cfg.frontend.height if cfg.frontend.height <= 240 else 240,
        )
        frame_iter = ((i * 0.033, f) for i, f in enumerate(frames_np))
        gt_positions = np.stack([-(R.T @ t) for R, t in gt_poses])
    elif args.dataset == "tum":
        from tinyslam.data.tum import FR1_INTRINSICS, TumSequence

        seq = TumSequence.open(args.root)
        intr = dict(FR1_INTRINSICS)
        cam = PinholeCamera.create(
            fx=args.fx or intr["fx"], fy=args.fy or intr["fy"],
            cx=args.cx or intr["cx"], cy=args.cy or intr["cy"],
        )
        frame_iter = seq.frames()
        if seq.groundtruth:
            gt_positions = seq.gt_positions()
    else:
        from tinyslam.data.euroc import EUROC_CAM0, EurocSequence

        seq = EurocSequence.open(args.root)
        cam = PinholeCamera.create(
            fx=args.fx or EUROC_CAM0["fx"], fy=args.fy or EUROC_CAM0["fy"],
            cx=args.cx or EUROC_CAM0["cx"], cy=args.cy or EUROC_CAM0["cy"],
        )
        frame_iter = seq.frames()
        if seq.groundtruth:
            gt_positions = seq.gt_positions()

    if args.mode == "slam":
        system = (DeviceSlam(cfg, cam, chunk=args.chunk)
                  if args.tracker == "device" else Slam(cfg, cam))
    else:
        system = (DeviceVO(cfg, cam, chunk=args.chunk)
                  if args.tracker == "device" else VisualOdometry(cfg, cam))
    metrics = Metrics()
    t0 = time.time()
    n_frames = 0
    for ts, img in frame_iter:
        if args.frames and n_frames >= args.frames:
            break
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        with metrics.timer("frame"):
            st = (system.process_frame(jnp.asarray(img))
                  if args.mode == "slam" else system.process(jnp.asarray(img)))
        metrics.step()
        if st is not None:  # device tracker stats lag by one chunk
            metrics.record("features", st.num_features)
            metrics.record("inliers", st.num_inliers)
            metrics.record("tracking", int(st.tracking))
        timestamps.append(ts)
        n_frames += 1
    if hasattr(system, "finalize"):
        system.finalize()
    elif hasattr(system, "flush"):
        system.flush()
    wall = time.time() - t0

    vo = system.vo if args.mode == "slam" else system
    tracked = sum(1 for s in vo.stats if s.tracking)
    # Frames the host tracker ran (bootstrap and re-bootstraps) are not
    # tracked frames of the device path.
    host_frames = getattr(vo, "host_frames", 0)
    after_boot = vo.stats[host_frames:] if host_frames else vo.stats
    summary = {
        "frames": n_frames,
        "tracked": tracked,
        "bootstrap_frames": host_frames,
        "tracked_frac_after_bootstrap": (
            sum(1 for s in after_boot if s.tracking) / max(len(after_boot), 1)),
        "keyframes": (len(system.kf_store) if args.mode == "slam"
                      else vo.num_keyframes),
        "landmarks": int(np.sum(np.asarray(vo.map.valid))),
        "wall_s": wall,
        "fps_incl_compile": n_frames / max(wall, 1e-9),
        "ate_sim3_m": None,
    }
    print(f"frames={n_frames} tracked={tracked} "
          f"keyframes={summary['keyframes']} "
          f"landmarks={summary['landmarks']} "
          f"fps={summary['fps_incl_compile']:.1f}")

    if gt_positions is not None and tracked > 5:
        # SLAM mode evaluates the corrected trajectory (keyframe BA and
        # pose-graph corrections propagated to every frame).
        est = system.positions if args.mode == "slam" else vo.positions
        first = next(i for i, s in enumerate(vo.stats) if s.tracking)
        n_eval = min(len(est), len(gt_positions))
        ate = ate_rmse(est[first:n_eval], gt_positions[first:n_eval])
        summary["ate_sim3_m"] = float(ate)
        print(f"ATE RMSE (Sim3): {ate:.4f} m")

    if args.output:
        from tinyslam.data.tum import quat_to_rotation  # noqa: F401
        with open(args.output, "w") as f:
            for ts, (R, t) in zip(timestamps, vo.trajectory):
                C = -R.T @ t
                f.write(f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} 0 0 0 1\n")
    if args.metrics:
        metrics.dump(args.metrics)
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
