"""Round-5: why does the keyframe-corrected dense trajectory score worse
than the raw online one on the eval sequence?  Runs DeviceSlam on a cached
sequence and reports per-segment (between reboots) ATE for corrected vs
raw, plus the per-frame error quantiles.

    python tools/diag_corr.py --cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=".seqcache/fr1_desk_like")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-reboot", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from tinyslam.config import SlamConfig
    from tinyslam.data.tum import FR1_INTRINSICS, TumSequence
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models.slam import DeviceSlam
    from tinyslam.utils.evaluation import ate_rmse, umeyama_alignment

    cfg = SlamConfig()
    if args.no_reboot:
        cfg = cfg.replace(vo=cfg.vo.replace(reloc_max_frames=0))
    seq = TumSequence.open(Path(args.seq))
    cam = PinholeCamera.create(**FR1_INTRINSICS)
    gt = seq.gt_positions()
    slam = DeviceSlam(cfg, cam)
    for ts, img in seq.frames():
        slam.process_frame(jnp.asarray(img))
    slam.finalize()

    est_c = slam.positions
    est_r = slam.raw_positions
    m = min(len(est_c), len(gt))
    first = next((i for i, s in enumerate(slam.vo.stats) if s.tracking), 0)

    def err_curve(est):
        s, R, t = umeyama_alignment(est[first:m], gt[first:m])
        al = (s * (R @ est[first:m].T)).T + t
        return np.linalg.norm(al - gt[first:m], axis=-1)

    ec, er = err_curve(est_c), err_curve(est_r)
    bounds = sorted({0, m - first} | {
        ev["frame"] - first for ev in slam.vo.submap_events
        if first < ev["frame"] < m})
    segs = list(zip(bounds[:-1], bounds[1:]))
    out = {
        "reboots": slam.vo.num_reboots,
        "reboot_frames": [ev["frame"] for ev in slam.vo.submap_events],
        "kf_frame_of": dict(sorted(slam.kf_frame_of.items())),
        "ate_corrected": round(ate_rmse(est_c[first:m], gt[first:m]), 4),
        "ate_raw": round(ate_rmse(est_r[first:m], gt[first:m]), 4),
        "seg_rmse": [
            {"seg": [a + first, b + first],
             "corrected": round(float(np.sqrt(np.mean(ec[a:b] ** 2))), 4),
             "raw": round(float(np.sqrt(np.mean(er[a:b] ** 2))), 4)}
            for a, b in segs],
        "worst_frames_corrected": [
            int(i) + first for i in np.argsort(-ec)[:10]],
        "err_deciles_corrected": [round(float(v), 3) for v in
                                  np.percentile(ec, range(0, 101, 10))],
        "err_deciles_raw": [round(float(v), 3) for v in
                            np.percentile(er, range(0, 101, 10))],
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
