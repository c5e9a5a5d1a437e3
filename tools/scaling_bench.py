"""Scaling-efficiency measurement (VERDICT r3 next-step #5).

Measures steady-state (post-compile) scaling of the two
communication-bound distributed stages — landmark-sharded BA and frame-DP
front-end extraction — plus BA iterations/s at the realistic window size
(K=10, L=2048), and writes one JSON artifact.

Methodology notes (recorded in the artifact):

- On this sandbox only virtual CPU devices exist (`--xla_force_host_
  platform_device_count`), and the host has very few physical cores; a
  device count beyond the core count oversubscribes and wall-clock
  "efficiency" measures the scheduler, not the design.  Rows are tagged
  `oversubscribed`; the honest hardware-parallel measurement is device
  counts up to the core count (typically 1 -> 2 here).
- One LM iteration of the sharded BA psums the pose-side blocks only —
  U (K,6,6) + gc (K,6) + Schur S_off (K,K,6,6) + rhs (K,6) + cost/count —
  independent of the landmark count L (parallel/dist_ba.py); the artifact
  records that payload (~16 KB/iteration at K=10).

    python tools/scaling_bench.py [--out SCALING.json] [--devices 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _ba_problem(rng, K, L, cam):
    from tinyslam.data.synthetic import (
        orbit_trajectory, project_points, random_points,
    )

    X = random_points(rng, L).astype(np.float32)
    poses = orbit_trajectory(K)
    z = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), bool)
    for k, (R, t) in enumerate(poses):
        uv, vis = project_points(cam, R, t, X, width=640, height=480,
                                 noise_px=0.5, rng=rng)
        z[:, k] = uv
        mask[:, k] = vis
    R0 = np.stack([np.asarray(p[0]) for p in poses])
    t0 = np.stack([np.asarray(p[1]) for p in poses])
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    pose_free = np.r_[[False, False], np.ones(K - 2, bool)]
    return R0, t0, X0, z, mask, pose_free


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="SCALING.json")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--weak-landmarks", type=int, default=512,
                    help="landmarks per device for the weak-scaling rows")
    ap.add_argument("--real", action="store_true",
                    help="use the real backend's devices (multi-chip pod); "
                         "default is a virtual CPU mesh")
    args = ap.parse_args()

    if not args.real:
        # Virtual CPU mesh: XLA_FLAGS must be set BEFORE the backend
        # initializes (i.e. before any jax.devices() call).
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    if not args.real:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tinyslam.backend.ba import bundle_adjust
    from tinyslam.config import FrontendConfig
    from tinyslam.data.synthetic import default_camera
    from tinyslam.parallel.dist_ba import bundle_adjust_sharded
    from tinyslam.parallel.frontend_dp import extract_features_batch
    from tinyslam.utils.cache import enable_compilation_cache
    from tinyslam.utils.profiling import time_call

    enable_compilation_cache()
    devices = jax.devices()[: args.devices]
    cores = os.cpu_count() or 1
    cam = default_camera(640, 480)
    rng = np.random.default_rng(0)
    K = 10
    ITERS = args.iters

    result = {
        "backend": jax.default_backend(),
        "host_physical_cores": cores,
        "methodology": (
            "median block_until_ready time; per-LM-iteration time = "
            "total/max_iters.  CAVEAT: XLA:CPU executes all virtual "
            "devices' compute in ONE shared thread pool, so wall-clock "
            "'efficiency' on the virtual mesh measures emulation "
            "serialization at every device count, not the design; the "
            "virtual mesh demonstrates CORRECTNESS and the collective "
            "structure (one O(K^2) psum per LM iteration, independent of "
            "L)"),
        "ba_weak": [], "ba_strong": [], "frontend_dp": [],
    }

    def mesh_for(n):
        return Mesh(np.asarray(devices[:n]).reshape(1, n),
                    ("frame", "landmark"))

    counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]

    # ---- BA weak scaling ----
    t1 = None
    for n in counts:
        L = args.weak_landmarks * n
        R0, t0, X0, z, mask, pose_free = _ba_problem(rng, K, L, cam)
        mesh = mesh_for(n)

        def run(Xp):
            return bundle_adjust_sharded(
                mesh, cam, jnp.asarray(R0), jnp.asarray(t0), Xp,
                jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free),
                max_iters=ITERS)["cost"]

        inputs = [(jnp.asarray(X0 + np.float32(1e-5 * i)),) for i in range(4)]
        dt = time_call(run, inputs, reps=5) / ITERS
        if t1 is None:
            t1 = dt
        result["ba_weak"].append({
            "devices": n, "landmarks_total": L,
            "ms_per_lm_iter": round(dt * 1e3, 3),
            "efficiency": round(t1 / dt, 3),
            "oversubscribed": n > cores,
        })
        print(f"ba_weak n={n} {dt*1e3:.2f} ms/iter eff={t1/dt:.2f}",
              flush=True)

    # ---- BA strong scaling ----
    L = args.weak_landmarks * max(counts)
    R0, t0, X0, z, mask, pose_free = _ba_problem(rng, K, L, cam)
    t1 = None
    for n in counts:
        mesh = mesh_for(n)

        def run(Xp):
            return bundle_adjust_sharded(
                mesh, cam, jnp.asarray(R0), jnp.asarray(t0), Xp,
                jnp.asarray(z), jnp.asarray(mask), jnp.asarray(pose_free),
                max_iters=ITERS)["cost"]

        inputs = [(jnp.asarray(X0 + np.float32(1e-5 * i)),) for i in range(4)]
        dt = time_call(run, inputs, reps=5) / ITERS
        if t1 is None:
            t1 = dt
        result["ba_strong"].append({
            "devices": n, "landmarks_total": L,
            "ms_per_lm_iter": round(dt * 1e3, 3),
            "efficiency": round(t1 / (n * dt), 3),
            "oversubscribed": n > cores,
        })
        print(f"ba_strong n={n} {dt*1e3:.2f} ms/iter eff={t1/(n*dt):.2f}",
              flush=True)

    # ---- Front-end frame-DP weak scaling: one 480p frame per device ----
    fcfg = FrontendConfig()
    t1 = None
    for n in counts:
        mesh = mesh_for(n)
        frames = [jnp.asarray(
            rng.random((n, fcfg.height, fcfg.width), np.float32))
            for _ in range(3)]

        def run(imgs):
            return extract_features_batch(imgs, 0.06, fcfg, mesh=mesh).count

        dt = time_call(run, [(f,) for f in frames], reps=4) / n
        if t1 is None:
            t1 = dt
        result["frontend_dp"].append({
            "devices": n, "frames_per_call": n,
            "ms_per_frame": round(dt * 1e3, 3),
            "efficiency": round(t1 / dt, 3),
            "oversubscribed": n > cores,
        })
        print(f"frontend_dp n={n} {dt*1e3:.2f} ms/frame eff={t1/dt:.2f}",
              flush=True)

    # ---- BA iterations/s at the realistic window (single device) ----
    R0, t0, X0, z, mask, pose_free = _ba_problem(rng, K, 2048, cam)

    def run_single(Xp):
        return bundle_adjust(
            cam, jnp.asarray(R0), jnp.asarray(t0), Xp, jnp.asarray(z),
            jnp.asarray(mask), jnp.asarray(pose_free), max_iters=ITERS)["cost"]

    inputs = [(jnp.asarray(X0 + np.float32(1e-5 * i)),) for i in range(4)]
    dt = time_call(run_single, inputs, reps=5) / ITERS
    result["ba_iterations_per_s"] = {
        "K": K, "L": 2048, "devices": 1,
        "value": round(1.0 / dt, 1),
        "ms_per_lm_iter": round(dt * 1e3, 3),
    }
    print(f"ba_iterations_per_s (K={K}, L=2048): {1.0/dt:.1f}", flush=True)

    # ---- per-iteration collective payload (O(K^2), independent of L) ----
    result["psum_payload_bytes_per_iter"] = (
        K * K * 36 + K * 6 + K * 36 + K * 6 + 2) * 4
    Path(args.out).write_text(json.dumps(result, indent=2))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
