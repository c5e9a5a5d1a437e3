"""Per-stage accuracy error budget (VERDICT r3 next-step #1).

Decomposes end-to-end ATE into its contributors so accuracy work targets
the right stage instead of guessing:

  1. bootstrap     — residual scale/rotation error of the two-view init
                     (Umeyama over the first tracked window);
  2. drift         — windowed Umeyama scale + position error vs distance
                     travelled, with BA on vs BA off (isolates what window
                     BA buys and how much of the drift is SCALE drift —
                     the component only a Sim(3) loop closure can remove);
  3. loop gates    — precision/recall of the loop-closure acceptance gates
                     against ground-truth revisits on a loop sequence, and
                     the accuracy of the measured relative scale s_e;
  4. end-to-end    — ATE with SE(3)-aligned vs Sim(3)-aligned evaluation
                     (the gap is the global-scale component).

    python tools/error_budget.py [--frames N] [--out ERRBUDGET.json]
                                 [--keep DIR] [--seq fr1|fr1_loop|mh01]

Writes one JSON artifact; sequences are the same renderers as
tools/eval_ate.py (cache with --keep to skip re-rendering).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


def _windowed_scale(est: np.ndarray, gt: np.ndarray, win: int = 30):
    """Umeyama scale + rmse per sliding window: scale drift profile."""
    from tinyslam.utils.evaluation import umeyama_alignment

    out = []
    for a in range(0, len(est) - win, max(win // 2, 1)):
        e, g = est[a:a + win], gt[a:a + win]
        if np.ptp(g, axis=0).max() < 1e-6:
            continue
        s, R, t = umeyama_alignment(e, g, with_scale=True)
        res = (s * (R @ e.T)).T + t - g
        out.append({"frame": a + win // 2, "scale": float(s),
                    "rmse": float(np.sqrt(np.mean(np.sum(res**2, -1))))})
    return out


def _dist_travelled(gt: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))


def _run_system(seq, cam, cfg, mode: str, tracker: str = "device"):
    import jax.numpy as jnp

    from tinyslam.models import DeviceSlam, DeviceVO

    if mode == "slam":
        system = DeviceSlam(cfg, cam)
    else:
        system = DeviceVO(cfg, cam)
    for ts, img in seq.frames():
        (system.process_frame if mode == "slam" else system.process)(
            img)
    if hasattr(system, "finalize"):
        system.finalize()
    else:
        system.flush()
    return system


def _load(kind: str, root: Path):
    from tinyslam.geometry.camera import PinholeCamera

    if kind == "tum":
        from tinyslam.data.tum import FR1_INTRINSICS, TumSequence

        return TumSequence.open(root), PinholeCamera.create(**FR1_INTRINSICS)
    from tinyslam.data.euroc import EUROC_CAM0, EurocSequence

    return EurocSequence.open(root), PinholeCamera.create(**EUROC_CAM0)


def budget_for_sequence(name: str, kind: str, root: Path) -> dict:
    from tinyslam.config import SlamConfig
    from tinyslam.utils.evaluation import ate_rmse, umeyama_alignment

    seq, cam = _load(kind, root)
    gt = seq.gt_positions()
    report: dict = {"sequence": name}

    # ---- stage 2: VO drift, BA on vs off (no loop closure) ----
    for tag, cfg in (
        ("ba_on", SlamConfig()),
        ("ba_off", SlamConfig().replace(
            ba=SlamConfig().ba.replace(max_iters=0))),
    ):
        vo = _run_system(seq, cam, cfg, mode="vo")
        est = vo.positions
        m = min(len(est), len(gt))
        first = next((i for i, s in enumerate(vo.stats) if s.tracking), 0)
        e, g = est[first:m], gt[first:m]
        # Scale drift is a WITHIN-submap quantity: each reboot re-normalizes
        # the monocular scale by design, so the profile is measured on the
        # longest contiguous submap segment.
        bounds = sorted({first, m} | {
            ev["frame"] for ev in getattr(vo, "submap_events", [])
            if first < ev["frame"] < m})
        seg = max(zip(bounds[:-1], bounds[1:]),
                  key=lambda ab: ab[1] - ab[0], default=(first, m))
        wscale = _windowed_scale(est[seg[0]:seg[1]], gt[seg[0]:seg[1]])
        scales = np.array([w["scale"] for w in wscale]) if wscale else np.ones(1)
        dist = _dist_travelled(gt[seg[0]:seg[1]])
        report[f"vo_{tag}"] = {
            "tracked": sum(1 for s in vo.stats if s.tracking),
            "frames": m,
            "reboots": getattr(vo, "num_reboots", 0),
            "drift_segment": [int(seg[0]), int(seg[1])],
            "ate_sim3_m": round(ate_rmse(e, g, with_scale=True), 4),
            "ate_se3_m": round(ate_rmse(e, g, with_scale=False), 4),
            "dist_travelled_m": round(dist, 2),
            # log-scale spread across windows = accumulated scale drift
            "scale_drift_logspread": round(
                float(np.log(scales.max() / scales.min())), 4),
            "scale_drift_per_m": round(
                float(np.log(scales.max() / scales.min()) / max(dist, 1e-6)),
                5),
            "windowed_scale": wscale,
        }
        if tag == "ba_on":
            # ---- stage 1: bootstrap (first tracked window of BA-on run) ----
            first_w = slice(first, min(first + 30, m))
            s_boot, _, _ = umeyama_alignment(est[first_w], gt[first_w])
            report["bootstrap"] = {
                "first_tracked_frame": first,
                # est->gt scale of the first window relative to the whole-run
                # alignment: 1.0 = bootstrap scale representative
                "window_scale_vs_run": round(
                    float(s_boot /
                          umeyama_alignment(e, g)[0]), 4),
                "window_rmse_m": round(
                    ate_rmse(est[first_w], gt[first_w]), 4),
            }

    # ---- stage 3+4: full SLAM with loop gates instrumented ----
    slam = _run_system(seq, cam, SlamConfig(), mode="slam")
    est = slam.positions
    m = min(len(est), len(gt))
    first = next((i for i, s in enumerate(slam.vo.stats) if s.tracking), 0)
    e, g = est[first:m], gt[first:m]

    # Exact keyframe -> frame mapping recorded at creation (r5: the
    # stats-flag inference mis-aligns across submap reboots).
    gt_all = gt[:len(slam.vo.stats)]

    def is_true_revisit(rec) -> bool:
        fi = slam.kf_frame_of.get(rec["kf"])
        fj = slam.kf_frame_of.get(rec["old"])
        if fi is None or fj is None or fi >= len(gt_all) or fj >= len(gt_all):
            return False
        return bool(np.linalg.norm(gt_all[fi] - gt_all[fj]) < 1.0)

    tp = fp = fn = tn = 0
    scale_errs = []
    for rec in slam.loop_log:
        truth = is_true_revisit(rec)
        if rec["accepted"] and truth:
            tp += 1
        elif rec["accepted"]:
            fp += 1
        elif truth:
            fn += 1
        else:
            tn += 1
        if rec["accepted"] and truth and np.isfinite(rec["s_e"]):
            scale_errs.append(rec["s_e"])
    report["loop_gates"] = {
        "candidates": len(slam.loop_log),
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": round(tp / max(tp + fp, 1), 3),
        "recall": round(tp / max(tp + fn, 1), 3),
        "accepted_scales": [round(s, 4) for s in scale_errs],
        "log": slam.loop_log[-50:],
    }
    raw = slam.raw_positions
    report["slam"] = {
        "loop_closures": slam.num_loop_closures,
        "keyframes": len(slam.kf_R),
        "reboots": getattr(slam.vo, "num_reboots", 0),
        "ate_sim3_m": round(ate_rmse(e, g, with_scale=True), 4),
        "ate_se3_m": round(ate_rmse(e, g, with_scale=False), 4),
        # Uncorrected online trajectory: the delta to ate_sim3_m is what
        # keyframe BA refinement + loop corrections bought.
        "ate_raw_sim3_m": round(
            ate_rmse(raw[first:m], g, with_scale=True), 4),
    }
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--out", default="ERRBUDGET.json")
    ap.add_argument("--keep", help="sequence cache dir")
    ap.add_argument("--seq", choices=["fr1", "fr1_loop", "mh01"],
                    action="append")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (accuracy is backend-"
                         "independent; keeps the GPU free for benchmarks)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import eval_ate  # tools/eval_ate.py — sequence builders

    work = Path(args.keep) if args.keep else Path(tempfile.mkdtemp())
    wanted = args.seq or ["fr1", "fr1_loop", "mh01"]
    builders = {
        "fr1": ("tum", "fr1_desk_like", eval_ate.build_fr1_desk_like),
        "fr1_loop": ("tum", "fr1_loop_like", eval_ate.build_fr1_loop_like),
        "mh01": ("euroc", "mh01_like", eval_ate.build_mh01_like),
    }
    reports = []
    for key in wanted:
        kind, name, build = builders[key]
        d = work / name
        probe = d / ("rgb.txt" if kind == "tum" else "mav0")
        if not probe.exists():
            print(f"building {name} ({args.frames} frames)...", flush=True)
            build(d, args.frames)
        print(f"budgeting {name}...", flush=True)
        rep = budget_for_sequence(name, kind, d)
        print(json.dumps({k: v for k, v in rep.items()
                          if k not in ("loop_gates",)}
                         | {"loop_gates": {k: v for k, v in
                                           rep["loop_gates"].items()
                                           if k != "log"}},
                         default=str), flush=True)
        reports.append(rep)

    Path(args.out).write_text(json.dumps(reports, indent=2, default=str))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
