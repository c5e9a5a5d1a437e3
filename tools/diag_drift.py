"""Round-5 scale-drift A/B: run DeviceVO (BA on) on a cached eval sequence
under a named config variant and report the windowed-Umeyama scale-drift
profile (the error_budget drift stage, standalone so variants can be
compared quickly).

    python tools/diag_drift.py --variant band_tight --cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


VARIANTS = {
    "baseline": {},                                   # current defaults
    "band_r4": {"tri_band_lo": 0.12, "tri_band_hi": 8.0},
    "band_tight": {"tri_band_lo": 0.4, "tri_band_hi": 2.5},
    "dup_global": {"dup_radius_px": 0.0},
    "no_staged": {"staged_reloc": False},
    "no_reboot": {"reloc_max_frames": 0},
    "r4_like": {"tri_band_lo": 0.12, "tri_band_hi": 8.0,
                "dup_radius_px": 0.0, "staged_reloc": False,
                "reloc_max_frames": 0},
    "local_band": {"tri_local_band": 1.8},
    "local_band_tight": {"tri_local_band": 1.4},
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=".seqcache/fr1_desk_like")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gt-depth", action="store_true",
                    help="per-anchor-keyframe est/gt landmark depth ratio "
                         "via the renderer's ray caster (fr1_desk_like "
                         "room, seed 101) — tells whether TRIANGULATION "
                         "bias leads the pose-scale drift")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from error_budget import _dist_travelled, _windowed_scale
    from tinyslam.config import SlamConfig
    from tinyslam.data.tum import FR1_INTRINSICS, TumSequence
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models import DeviceVO
    from tinyslam.utils.evaluation import ate_rmse

    cfg = SlamConfig()
    cfg = cfg.replace(vo=cfg.vo.replace(**VARIANTS[args.variant]))
    seq = TumSequence.open(Path(args.seq))
    cam = PinholeCamera.create(**FR1_INTRINSICS)
    gt = seq.gt_positions()

    vo = DeviceVO(cfg, cam)
    for ts, img in seq.frames():
        vo.process(img)
    vo.flush()
    est = vo.positions
    m = min(len(est), len(gt))
    first = next((i for i, s in enumerate(vo.stats) if s.tracking), 0)
    e, g = est[first:m], gt[first:m]
    # Within-submap drift: reboots re-normalize scale by design.
    bounds = sorted({first, m} | {
        ev["frame"] for ev in vo.submap_events if first < ev["frame"] < m})
    seg = max(zip(bounds[:-1], bounds[1:]),
              key=lambda ab: ab[1] - ab[0], default=(first, m))
    ws = _windowed_scale(est[seg[0]:seg[1]], gt[seg[0]:seg[1]])
    scales = np.array([w["scale"] for w in ws]) if ws else np.ones(1)
    dist = _dist_travelled(gt[seg[0]:seg[1]])
    out = {
        "variant": args.variant,
        "backend": jax.default_backend(),
        "tracked": sum(1 for s in vo.stats if s.tracking),
        "reboots": vo.num_reboots,
        "ate_sim3_m": round(ate_rmse(e, g, with_scale=True), 4),
        "scale_drift_logspread": round(
            float(np.log(scales.max() / scales.min())), 4),
        "scale_drift_per_m": round(
            float(np.log(scales.max() / scales.min()) / max(dist, 1e-6)), 5),
        "windowed_scale": [round(float(s), 3) for s in scales],
    }
    if args.gt_depth and vo.state is not None and vo.num_reboots == 0:
        from tinyslam.data.synthetic import TexturedRoom

        room = TexturedRoom(np.random.default_rng(101), tex_res=256,
                            octaves=4)
        mp = vo.map
        X = np.asarray(mp.X)
        valid = np.asarray(mp.valid)
        anchor = np.asarray(mp.anchor_kf)
        # anchor kf id -> frame index (keyframe flags in stats order).
        kf_frames = [i for i, s in enumerate(vo.stats) if s.is_keyframe]
        gt_poses = [(R, t) for _, R, t in seq.groundtruth]
        ratios: dict[int, list[float]] = {}
        for k in sorted(set(anchor[valid])):
            if k < 0 or k >= len(kf_frames):
                continue
            f = kf_frames[k]
            if f >= min(len(vo.trajectory), len(gt_poses)):
                continue
            sel = valid & (anchor == k)
            Xk = X[sel]
            R_e, t_e = vo.trajectory[f]
            pc = Xk @ np.asarray(R_e).T + np.asarray(t_e)
            z_e = pc[:, 2]
            front = z_e > 1e-3
            uv = np.stack([
                float(cam.fx) * pc[:, 0] / np.maximum(z_e, 1e-6)
                + float(cam.cx),
                float(cam.fy) * pc[:, 1] / np.maximum(z_e, 1e-6)
                + float(cam.cy)], -1)
            R_g, t_g = gt_poses[f]
            P_gt = room.raycast(cam, R_g, t_g, uv)
            z_g = (P_gt @ np.asarray(R_g).T + np.asarray(t_g))[:, 2]
            ok = front & (z_g > 1e-3)
            if ok.sum() >= 10:
                ratios[int(k)] = float(np.median(z_e[ok] / z_g[ok]))
        if ratios:
            r0 = next(iter(ratios.values()))
            out["gt_depth_ratio_by_kf"] = {
                str(k): round(v / r0, 4) for k, v in ratios.items()}

    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
