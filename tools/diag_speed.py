"""Round-5 wall-clock budget for the device tracker on real frames.

Times, separately: sequence loading, host->device upload, track_chunk
compile, steady-state per-chunk dispatch, flush/readback — so 'eval fps'
decomposes into compile vs loader vs dispatch instead of one number.

    python tools/diag_speed.py [--seq .seqcache/fr1_desk_like] [--frames 120]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=".seqcache/fr1_desk_like")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args()

    if not args.no_cache:
        from tinyslam.utils.cache import enable_compilation_cache

        enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from tinyslam.config import SlamConfig
    from tinyslam.data.tum import FR1_INTRINSICS, TumSequence
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models import DeviceVO

    seq = TumSequence.open(Path(args.seq))
    cam = PinholeCamera.create(**FR1_INTRINSICS)

    t0 = time.time()
    frames = []
    for ts, img in seq.frames():
        frames.append(img)
        if len(frames) >= args.frames:
            break
    t_load = time.time() - t0

    cfg = SlamConfig()
    vo = DeviceVO(cfg, cam, chunk=args.chunk)

    # Bootstrap (host path) until initialized.
    t0 = time.time()
    i = 0
    while not vo.initialized and i < len(frames):
        vo.process(jnp.asarray(frames[i]))
        i += 1
    t_boot = time.time() - t0
    n_boot = i

    # First chunk = compile + run.
    t0 = time.time()
    while len(vo._pending) == 0 and i < len(frames):
        vo.process(jnp.asarray(frames[i]))
        i += 1
    jax.block_until_ready(vo.state.t)
    t_first_chunk = time.time() - t0

    # Steady state chunks.
    t0 = time.time()
    n_steady = 0
    chunk_times = []
    while i < len(frames):
        tc = time.time()
        before = len(vo._pending)
        while len(vo._pending) == before and i < len(frames):
            vo.process(jnp.asarray(frames[i]))
            i += 1
            n_steady += 1
        jax.block_until_ready(vo.state.t)
        chunk_times.append(time.time() - tc)
    t_steady = time.time() - t0

    t0 = time.time()
    vo.flush()
    t_flush = time.time() - t0

    out = {
        "backend": jax.default_backend(),
        "frames": len(frames),
        "chunk": args.chunk,
        "load_s": round(t_load, 2),
        "load_fps": round(args.frames / t_load, 1),
        "bootstrap_s": round(t_boot, 2),
        "bootstrap_frames": n_boot,
        "first_chunk_s": round(t_first_chunk, 2),
        "steady_s": round(t_steady, 3),
        "steady_frames": n_steady,
        "steady_fps": round(n_steady / t_steady, 1) if t_steady else None,
        "chunk_times_ms": [round(t * 1000, 1) for t in chunk_times],
        "flush_s": round(t_flush, 3),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
