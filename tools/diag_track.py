"""Per-config tracked-frame comparison on a cached eval sequence: isolates
which component (matcher path, VO settings) moves tracking.

    python tools/diag_track.py --seq .seqcache/fr1_desk_like [--variant NAME]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(seq_dir: Path, variant: str, frames: int) -> dict:
    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from tinyslam.config import SlamConfig
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models import DeviceVO
    from tinyslam.utils.evaluation import ate_rmse

    if (seq_dir / "mav0").exists():
        from tinyslam.data.euroc import EUROC_CAM0, EurocSequence

        seq = EurocSequence.open(seq_dir)
        cam = PinholeCamera.create(**EUROC_CAM0)
    else:
        from tinyslam.data.tum import FR1_INTRINSICS, TumSequence

        seq = TumSequence.open(seq_dir)
        cam = PinholeCamera.create(**FR1_INTRINSICS)
    gt = seq.gt_positions()

    cfg = SlamConfig()
    # ops.hamming.matcher_path is the one place that chooses the matcher;
    # the variant patches it for the whole run (before anything is traced).
    matcher = contextlib.nullcontext()
    if variant == "xla_matcher":
        matcher = mock.patch("tinyslam.ops.hamming.matcher_path",
                             return_value="xla")
    elif variant.startswith("vo:"):
        # e.g. --variant vo:track_radius_px=32,reloc_max_frames=6
        kw = {}
        for item in variant[3:].split(","):
            k, v = item.split("=")
            f = type(getattr(SlamConfig().vo, k))
            kw[k] = f(v)
        cfg = cfg.replace(vo=cfg.vo.replace(**kw))
    elif variant == "baseline":
        pass
    else:
        raise SystemExit(f"unknown variant {variant}")

    vo = DeviceVO(cfg, cam)
    t0 = time.time()
    n = 0
    with matcher:
        for ts, img in seq.frames():
            vo.process(img)
            n += 1
            if n >= frames:
                break
        vo.flush()
    wall = time.time() - t0
    tracked = sum(1 for s in vo.stats if s.tracking)
    first = next((i for i, s in enumerate(vo.stats) if s.tracking), 0)
    est = vo.positions
    m = min(len(est), len(gt))
    out = {
        "variant": variant,
        "backend": jax.default_backend(),
        "frames": n,
        "tracked": tracked,
        "keyframes": vo.num_keyframes,
        "ate_sim3_m": round(ate_rmse(est[first:m], gt[first:m],
                                     with_scale=True), 4),
        "fps": round(n / wall, 1),
        # per-frame traces for failure diagnosis
        "inliers_hist": [int(s.num_inliers) for s in vo.stats],
        "matches_hist": [int(s.num_matches) for s in vo.stats],
        "features_hist": [int(s.num_features) for s in vo.stats],
        "landmarks_hist": [int(s.num_landmarks) for s in vo.stats],
        "keyframe_hist": [bool(s.is_keyframe) for s in vo.stats],
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=".seqcache/fr1_desk_like")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--out")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    out = run(Path(args.seq), args.variant, args.frames)
    line = dict(out)
    h = line.pop("inliers_hist")
    line["inliers_min"] = min(h) if h else 0
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
