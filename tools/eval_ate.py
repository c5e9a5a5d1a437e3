"""Accuracy evaluation on realistic rendered sequences (BASELINE configs 3-5
stand-ins: the sandbox has no network access, so TUM fr1 / EuRoC MH_01 frames
cannot be fetched; these sequences reproduce their *statistics* — full
resolution, real intrinsics AND lens distortion, handheld/MAV motion,
vignetting, auto-exposure hunting, sensor noise, 8-bit quantization — and are
written to disk in the real dataset layouts so the eval exercises the actual
loaders (native PNG decode, radtan undistortion) end to end.

    python tools/eval_ate.py [--frames N] [--out EVAL.json] [--keep DIR]

Prints one JSON line per sequence and writes the combined artifact.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_fr1_desk_like(root: Path, num_frames: int) -> None:
    from tinyslam.data.synthetic import (
        TexturedRoom, handheld_trajectory, render_sequence, write_tum_sequence,
    )
    from tinyslam.data.tum import FR1_DIST, FR1_INTRINSICS
    from tinyslam.geometry.camera import PinholeCamera

    rng = np.random.default_rng(101)
    # Interior clutter (r5): fr1_desk is a CLUTTERED desk scene — a bare
    # box room is unrealistically planar near walls and unrealistically
    # self-similar in appearance (uniform random-grid texture defeats any
    # descriptor; real scenes carry distinctive local structure).  Clutter
    # raises geometric difficulty (occlusion, depth discontinuities) while
    # restoring realistic appearance distinctiveness.
    room = TexturedRoom(rng, tex_res=256, octaves=4, clutter=8)
    cam = PinholeCamera.create(**FR1_INTRINSICS)
    poses = handheld_trajectory(rng, num_frames)
    frames = render_sequence(rng, poses, cam, 640, 480, room, dist=FR1_DIST)
    write_tum_sequence(root, frames, poses, fps=30.0)


def build_fr1_loop_like(root: Path, num_frames: int) -> None:
    """A full-circuit handheld walk (~378 degrees) that RETURNS to its
    start: the trajectory revisit the place-recognition stack needs to
    demonstrate an actual loop closure (fr1's room statistics otherwise)."""
    from tinyslam.data.synthetic import (
        TexturedRoom, handheld_trajectory, render_sequence, write_tum_sequence,
    )
    from tinyslam.data.tum import FR1_DIST, FR1_INTRINSICS
    from tinyslam.geometry.camera import PinholeCamera

    rng = np.random.default_rng(303)
    room = TexturedRoom(rng, tex_res=256, octaves=4, clutter=10)
    cam = PinholeCamera.create(**FR1_INTRINSICS)
    step = (2.0 * np.pi + 0.35) / num_frames
    poses = handheld_trajectory(rng, num_frames, step=step,
                                jitter_pos=0.003, jitter_tgt=0.008)
    frames = render_sequence(rng, poses, cam, 640, 480, room, dist=FR1_DIST)
    write_tum_sequence(root, frames, poses, fps=30.0)


def build_mh01_like(root: Path, num_frames: int) -> None:
    from tinyslam.data.euroc import EUROC_CAM0, EUROC_DIST
    from tinyslam.data.synthetic import (
        TexturedRoom, mav_trajectory, render_sequence, write_euroc_sequence,
    )
    from tinyslam.geometry.camera import PinholeCamera

    rng = np.random.default_rng(202)
    room = TexturedRoom(rng, half_size=(8.0, 5.0, 8.0), tex_res=256,
                        octaves=4, clutter=16)
    cam = PinholeCamera.create(**EUROC_CAM0)
    poses = mav_trajectory(rng, num_frames)
    frames = render_sequence(rng, poses, cam, 752, 480, room, dist=EUROC_DIST)
    write_euroc_sequence(root, frames, poses, fps=20.0)


def run_sequence(name: str, kind: str, root: Path, mode: str,
                 tracker: str = "device") -> dict:
    import jax
    import jax.numpy as jnp

    from tinyslam.config import SlamConfig
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models import DeviceSlam, DeviceVO, Slam, VisualOdometry
    from tinyslam.utils.evaluation import ate_rmse, rpe

    if kind == "tum":
        from tinyslam.data.tum import FR1_INTRINSICS, TumSequence

        seq = TumSequence.open(root)
        cam = PinholeCamera.create(**FR1_INTRINSICS)
    else:
        from tinyslam.data.euroc import EUROC_CAM0, EurocSequence

        seq = EurocSequence.open(root)
        cam = PinholeCamera.create(**EUROC_CAM0)
    gt = seq.gt_positions()

    # Data-layer-only throughput probe (PNG decode + undistortion, host
    # CPU): bounds how much of the end-to-end fps is the loader, not SLAM.
    t0 = time.time()
    n_probe = 0
    for ts, img in seq.frames():
        n_probe += 1
        if n_probe >= 50:
            break
    data_fps = n_probe / max(time.time() - t0, 1e-9)

    cfg = SlamConfig()
    if mode == "slam":
        system = (DeviceSlam(cfg, cam) if tracker == "device"
                  else Slam(cfg, cam))
    else:
        system = (DeviceVO(cfg, cam) if tracker == "device"
                  else VisualOdometry(cfg, cam))
    t0 = time.time()
    n = 0
    stamps = []                         # per-frame completion timestamps
    for ts, img in seq.frames():
        im = img   # host numpy: DeviceVO batches the upload per chunk
        (system.process_frame if mode == "slam" else system.process)(im)
        n += 1
        stamps.append(time.time())
    if hasattr(system, "finalize"):
        system.finalize()
    elif hasattr(system, "flush"):
        system.flush()
    wall = time.time() - t0
    # Steady-state fps: drop the JIT warmup (bootstrap compiles + the first
    # tracked chunk's compile).  In deployment those are one-time AOT
    # costs; the persistent compile cache makes later processes skip them.
    warm_n = min(40, max(1, n // 3))
    steady_fps = ((n - warm_n) / max(stamps[-1] - stamps[warm_n - 1], 1e-9)
                  if n > warm_n else float("nan"))
    vo = system.vo if mode == "slam" else system
    tracked = sum(1 for s in vo.stats if s.tracking)
    first = next((i for i, s in enumerate(vo.stats) if s.tracking), 0)
    # SLAM mode evaluates the CORRECTED trajectory (keyframe BA + pose-graph
    # corrections propagated to every frame); the raw online trajectory is
    # kept as the ablation column so a loop closure's ATE delta is visible.
    est = system.positions if mode == "slam" else vo.positions
    traj = system.trajectory if mode == "slam" else vo.trajectory
    m = min(len(est), len(gt))
    ate = ate_rmse(est[first:m], gt[first:m])        # Sim(3)-aligned
    ate_se3 = ate_rmse(est[first:m], gt[first:m], with_scale=False)
    ate_raw = None
    if mode == "slam":
        raw = system.raw_positions
        ate_raw = ate_rmse(raw[first:m], gt[first:m])
    rpe_t, rpe_r = rpe(traj[first:m],
                       [(R, t) for _, R, t in seq.groundtruth][first:m])
    kf_total = (len(system.kf_store) if mode == "slam"
                else vo.num_keyframes)
    out = {
        "sequence": name,
        "mode": mode,
        "tracker": tracker,
        "frames": n,
        "tracked": tracked,
        "reboots": getattr(vo, "num_reboots", 0),
        "host_frames": getattr(vo, "host_frames", None),
        "keyframes": kf_total,
        "loop_closures": getattr(system, "num_loop_closures", 0),
        "ate_rmse_m": round(ate, 4),
        "ate_se3_m": round(ate_se3, 4),
        "ate_raw_m": round(ate_raw, 4) if ate_raw is not None else None,
        "rpe_trans_m": round(rpe_t, 4),
        "rpe_rot_deg": round(rpe_r, 3),
        "fps": round(n / wall, 1),
        "steady_fps": round(steady_fps, 1),
        "warmup_s": round(stamps[warm_n - 1] - t0, 1) if n else 0.0,
        "data_fps": round(data_fps, 1),
        "backend": jax.default_backend(),
        "stage_budget_s": {
            k: round(v, 2)
            for k, v in getattr(system, "timings", {}).items()},
        "loop_log_tail": getattr(system, "loop_log", [])[-10:],
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--out", default="EVAL.json")
    ap.add_argument("--keep", help="keep generated sequences in this dir")
    ap.add_argument("--mode", choices=["vo", "slam"], default="slam")
    ap.add_argument("--tracker", choices=["device", "host"], default="device")
    ap.add_argument("--only", choices=["fr1", "fr1_loop", "mh01"])
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (accuracy iteration; the "
                         "committed artifact should run on the chip)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    work = Path(args.keep) if args.keep else Path(tempfile.mkdtemp())
    results = []
    try:
        if args.only in (None, "fr1"):
            d = work / "fr1_desk_like"
            if not (d / "rgb.txt").exists():
                print(f"building fr1_desk_like ({args.frames} frames)...",
                      flush=True)
                build_fr1_desk_like(d, args.frames)
            results.append(run_sequence("fr1_desk_like", "tum", d, args.mode,
                                        args.tracker))
        if args.only in (None, "fr1_loop"):
            d = work / "fr1_loop_like"
            if not (d / "rgb.txt").exists():
                print(f"building fr1_loop_like ({args.frames} frames)...",
                      flush=True)
                build_fr1_loop_like(d, args.frames)
            results.append(run_sequence("fr1_loop_like", "tum", d, args.mode,
                                        args.tracker))
        if args.only in (None, "mh01"):
            d = work / "mh01_like"
            if not (d / "mav0").exists():
                print(f"building mh01_like ({args.frames} frames)...",
                      flush=True)
                build_mh01_like(d, args.frames)
            results.append(run_sequence("mh01_like", "euroc", d, args.mode,
                                        args.tracker))
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)

    artifact = {
        "target_ate_m": 0.05,
        "note": ("rendered sequences with real-dataset statistics "
                 "(intrinsics+distortion+photometrics+interior clutter); "
                 "no network access to the actual TUM/EuRoC files in this "
                 "environment"),
        "results": results,
    }
    Path(args.out).write_text(json.dumps(artifact, indent=2))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
