"""Kernel rooflines on the GPU (BASELINE: "kernels at speed-of-light").

For each hot kernel: measured time (median of calls timed to
jax.block_until_ready), a speed-of-light floor from its bytes and FLOPs
against the device's published peaks (utils/profiling.PEAKS, keyed by
device_kind; an unknown device is an error), and the achieved fraction.
A large bf16 matmul and a large copy are measured beside them as the
ceilings this card reaches in practice.

    python tools/profile_roofline.py [--out roofline.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tinyslam.config import FrontendConfig, SlamConfig
    from tinyslam.utils.cache import enable_compilation_cache
    from tinyslam.utils.profiling import device_peaks, time_call

    peaks = device_peaks()
    HBM_GBS = peaks["hbm_bytes_s"]
    BF16_FLOPS = peaks["bf16_flops"]
    enable_compilation_cache()
    rng = np.random.default_rng(0)
    results = {}

    def record(name, t_s, floor_s, note):
        results[name] = {
            "time_ms": t_s * 1e3,
            "roofline_ms": floor_s * 1e3,
            "pct_of_roofline": 100 * floor_s / t_s,
            "note": note,
        }
        print(f"{name:26s} {t_s*1e3:8.4f} ms   floor {floor_s*1e3:7.4f} ms"
              f"   {100*floor_s/t_s:5.1f}%")

    # --- practical ceilings: large bf16 matmul and large copy ---
    a = jnp.asarray(rng.standard_normal((8192, 8192)), jnp.bfloat16)
    t = time_call(jax.jit(lambda x: x @ x), [(a,)], reps=10)
    record("bf16_matmul_8192", t, 2 * 8192**3 / BF16_FLOPS,
           "practical tensor-core ceiling")
    big = jnp.zeros((256 * 2**20,), jnp.float32)
    t = time_call(jax.jit(lambda x: x + 1.0), [(big,)], reps=10)
    record("copy_1GiB", t, 2 * big.nbytes / HBM_GBS,
           "practical memory ceiling (read + write)")

    H, W = 480, 640
    imgs = [jnp.asarray(rng.random((H, W), np.float32)) for _ in range(8)]

    # --- full front-end ---
    from tinyslam.frontend.orb import extract_features

    cfg = FrontendConfig()
    fe = jax.jit(lambda im: extract_features(im, jnp.float32(0.06), cfg))
    t = time_call(fe, [(im,) for im in imgs])
    # pyramid levels ~1.33x base for score/moments passes + BRIEF gathers
    floor = (4 * H * W * 4 * 1.34 + cfg.max_features * 256 * 2) / HBM_GBS
    record("frontend_extract", t, floor,
           "grayscale->pyramid->FAST->topk->BRIEF, 4 levels, 2048 feats")

    # --- fused matcher (guided, 2048 x 8192) vs the XLA path ---
    from tinyslam.ops.hamming import match_descriptors

    N, M = 2048, 8192
    db = jnp.asarray(rng.integers(0, 2**32 - 1, (M, 8), np.uint32))
    vb = jnp.ones((M,), bool)
    va = jnp.ones((N,), bool)
    xy = jnp.asarray(rng.uniform(0, 640, (N, 2)).astype(np.float32))
    proj = jnp.asarray(rng.uniform(0, 640, (M, 2)).astype(np.float32))
    dsets = [(jnp.asarray(rng.integers(0, 2**32 - 1, (N, 8), np.uint32)),)
             for _ in range(4)]
    fm = lambda d: match_descriptors(d, va, db, vb, xy_a=xy, proj_b=proj,
                                     radius_px=20.0)["idx_b"]
    t = time_call(fm, dsets)
    flops = 2 * N * M * 256
    bytes_ = (N + M) * 256  # int8 signs
    floor = max(flops / BF16_FLOPS, bytes_ / HBM_GBS)
    record("match_fused", t, floor,
           "guided 2048x8192 Hamming: best/second/argmin + cross-check")

    fx = lambda d: match_descriptors(d, va, db, vb, xy_a=xy, proj_b=proj,
                                     radius_px=20.0,
                                     kernel=False)["idx_b"]
    t = time_call(fx, dsets)
    record("match_xla_reference", t, floor,
           "same op, XLA path (materialized (N,M) matrix)")

    # --- one windowed-BA LM iteration (compacted problem) ---
    from tinyslam.backend.ba import bundle_adjust
    from tinyslam.data.synthetic import (
        default_camera, orbit_trajectory, project_points, random_points,
    )

    scfg = SlamConfig()
    cam = default_camera(W, H)
    K, L = scfg.ba.max_keyframes, scfg.ba.max_landmarks
    X = random_points(rng, L).astype(np.float32)
    poses = orbit_trajectory(K)
    z = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), bool)
    for k, (R, t_) in enumerate(poses):
        uv, vis = project_points(cam, R, t_, X, width=W, height=H,
                                 noise_px=0.3, rng=rng)
        z[:, k] = uv
        mask[:, k] = vis
    pose_free = jnp.asarray(np.r_[[False, False], np.ones(K - 2, bool)])
    zj, maskj = jnp.asarray(z), jnp.asarray(mask)
    Rj = jnp.asarray(np.stack([p[0] for p in poses]))
    tj = jnp.asarray(np.stack([p[1] for p in poses]))
    Xs = [(jnp.asarray(X + rng.normal(0, 0.01, X.shape).astype(np.float32)),)
          for _ in range(4)]

    def ba_iters(it):
        g = jax.jit(lambda X0: bundle_adjust(
            cam, Rj, tj, X0, zj, maskj, pose_free, max_iters=it)["t"])
        return time_call(g, Xs, reps=10)

    t1, t4 = ba_iters(1), ba_iters(4)
    per_iter = (t4 - t1) / 3
    # blocks x2 + schur: ~14 (K-major) tensors of (K,2|6,3|6,L) f32
    ba_bytes = 14 * K * 2 * 6 * L * 4
    floor = ba_bytes / HBM_GBS
    record("ba_lm_iteration", per_iter, floor,
           f"Schur-LM iteration, K={K} x L={L} window (compacted)")

    results["_meta"] = {
        "device_kind": jax.devices()[0].device_kind,
        "method": "median of calls timed to jax.block_until_ready",
        "peaks": peaks,
    }
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
