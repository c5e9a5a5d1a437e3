"""Per-stage device times of the tracker on the GPU.

Bootstraps the device tracker on the chip_smoke sequence (rendered into
.smoke_seq/ if absent), then measures on the card:

  - extract: wall time per call, and a device-trace split by named scope
    (downsample, blur, FAST score, moments, NMS, top-k, BRIEF), and per
    pyramid level the stencil stages beside their memory floor;
  - guided matching against the map (device time from a trace) and the
    tracked chunk (wall time, and its device time split by the same scopes
    plus the matcher's), each with the fused matcher kernel and with the
    XLA matcher, in turns (on, off, on, off), to decide whether the kernel
    pays end to end.  The XLA variant is compiled with
    ``ops.hamming.matcher_path`` patched to answer "xla": it is the one
    place that chooses the matcher.

Wall times are medians of block_until_ready-timed calls.  Results print as
one JSON object, and also go to --out when given.

    python tools/profile_stages.py [--out profile_stages.json]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# Innermost scope first: "moments" sits inside "fast".
STAGES = ("moments", "nms", "fast", "topk", "brief", "blur", "downsample",
          "match")
EXTRACT_STAGES = STAGES[:-1]
# Pallas kernels are named in the trace by their ``name``, not by an HLO
# instruction.
KERNEL_STAGES = {"hamming_match_fused": "match"}


def stage_of(op_name: str) -> str:
    parts = op_name.split("/")
    return next((s for s in STAGES if s in parts), "other")


def level_of(op_name: str) -> int | None:
    """The pyramid level of an op inside an ``orb_level<n>`` scope."""
    m = re.search(r"(?:^|/)orb_level(\d+)(?:/|$)", op_name)
    return int(m.group(1)) if m else None


def op_name_of(kernel: str, names: dict) -> str | None:
    """The op_name of a trace kernel: its HLO instruction's, or that of the
    instruction it was split from (XLA names a sort's kernels
    ``sort_7_1__2`` after ``sort.7``)."""
    while kernel:
        if kernel in names:
            return names[kernel]
        head, sep, tail = kernel.rpartition("_")
        if not sep or not tail.isdigit():
            return None
        kernel = head.rstrip("_")
    return None


def scope_split(compiled, args, calls: int = 10,
                show: bool = True) -> tuple[dict, dict]:
    """Device ms per call of the compiled ``compiled(*args)``: per stage
    (kernels not found in the compiled module count under "unattributed"
    as well as "other"), and per pyramid level and stage."""
    from tinyslam.utils.profiling import device_seconds_per_call, hlo_op_names

    names = hlo_op_names(compiled.as_text())
    per_op = device_seconds_per_call(compiled, args, calls)
    total = per_op.pop("total")
    split = {"total": total * 1e3, "unattributed": 0.0}
    by_level: dict[int, dict[str, float]] = {}
    for op, sec in sorted(per_op.items()):
        op_name = op_name_of(op, names)
        if op_name is None and op in KERNEL_STAGES:
            op_name = KERNEL_STAGES[op]
        if op_name is None:
            split["unattributed"] += sec * 1e3
            if show:
                print(f"  unattributed kernel {op}: {sec * 1e3:.4f} ms")
        stage = stage_of(op_name or "")
        split[stage] = split.get(stage, 0.0) + sec * 1e3
        lvl = level_of(op_name or "")
        if lvl is not None:
            row = by_level.setdefault(lvl, {})
            row[stage] = row.get(stage, 0.0) + sec * 1e3
    return split, by_level


def compile_on(fn, args, path: str):
    """``fn`` compiled for ``args`` with the matcher on ``path`` ("triton"
    or "xla").  The choice is made at trace time, so the staging caches are
    cleared around it; the returned executable keeps its choice."""
    import jax

    jax.clear_caches()
    with mock.patch("tinyslam.ops.hamming.matcher_path", return_value=path):
        compiled = jax.jit(fn).lower(*args).compile()
    jax.clear_caches()
    return compiled


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()

    from chip_smoke import card_line, render_sequence, require_gpu

    dev = require_gpu()
    import jax
    import jax.numpy as jnp

    from tinyslam.config import SlamConfig
    from tinyslam.data.tum import FR1_INTRINSICS, TumSequence
    from tinyslam.frontend.orb import extract_features
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.models.vo import _match_to_map
    from tinyslam.models.vo_device import DeviceVO, track_chunk
    from tinyslam.utils.cache import enable_compilation_cache
    from tinyslam.utils.profiling import (
        device_peaks, device_seconds_per_call, time_call,
    )

    enable_compilation_cache()
    card = card_line()
    res = {"card": card, "device_kind": dev.device_kind}
    print(f"card: {card}", flush=True)

    frames = [np.asarray(f) for _, f in
              TumSequence.open(render_sequence()).frames()]
    cfg = SlamConfig()
    cam = PinholeCamera.create(**FR1_INTRINSICS)
    chunk = 16
    vo = DeviceVO(cfg, cam, chunk=chunk)
    i = 0
    while not vo.initialized:
        vo.process(frames[i])
        i += 1
    for f in frames[i:i + 2 * chunk]:       # let the map fill out
        vo.process(f)
    vo.flush()
    i += 2 * chunk
    state = vo.state
    res["landmarks"] = int(jnp.sum(state.map.valid))
    ims = jnp.asarray(np.stack(frames[i:i + chunk]))
    active = jnp.ones((chunk,), bool)
    imgs = [ims[k] for k in range(4)]

    # ---- extract: wall time and device split by stage ----
    fc = cfg.frontend
    fe = jax.jit(lambda im: extract_features(im, state.threshold, fc))
    res["extract_ms"] = time_call(fe, [(im,) for im in imgs]) * 1e3
    split, by_level = scope_split(fe.lower(imgs[0]).compile(), (imgs[0],))
    res["extract_device_ms"] = split
    print("extract split (device ms/call):",
          {k: round(v, 4) for k, v in split.items()}, flush=True)
    hbm = device_peaks(dev)["hbm_bytes_s"]
    res["stencil_by_level"] = {}
    for lvl in range(fc.num_levels):
        # FAST/NMS/moments/blur read the level image and write 5 f32 maps
        # (raw and NMS score, m10, m01, blurred).
        floor = 6 * (fc.height >> lvl) * (fc.width >> lvl) * 4 / hbm * 1e3
        row = {s: by_level.get(lvl, {}).get(s, 0.0)
               for s in ("fast", "moments", "nms", "blur")}
        row["sum"] = sum(row.values())
        row["floor"] = floor
        res["stencil_by_level"][lvl] = row
        print(f"level {lvl} stencil device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"  ({row['sum'] / floor:.1f}x floor)  [{card}]", flush=True)

    # ---- matcher and tracked chunk: Triton / XLA matcher, in turns ----
    feats = fe(imgs[0])
    mc = cfg.matcher

    def match(f):
        return _match_to_map(f, state.map, mc.max_distance, mc.ratio,
                             cam=cam, R=state.R, t=state.t,
                             radius_px=cfg.vo.track_radius_px)

    def run(s, x, a):
        return track_chunk(cam, cfg, s, x, a)

    chunk_args = (state, ims, active)
    variants = {path: (compile_on(match, (feats,), path),
                       compile_on(run, chunk_args, path))
                for path in ("triton", "xla")}
    for turn, path in enumerate(("triton", "xla", "triton", "xla")):
        match_c, run_c = variants[path]
        t_m = device_seconds_per_call(match_c, (feats,))["total"] * 1e3
        t_c = time_call(run_c, [chunk_args], reps=5) * 1e3
        split, _ = scope_split(run_c, chunk_args, calls=3, show=False)
        s = np.asarray(run_c(*chunk_args)[1]["summary"])
        extract = sum(split.get(k, 0.0) for k in EXTRACT_STAGES)
        res[f"turn{turn}_{path}"] = {
            "match_guided_device_ms": t_m, "track_chunk_ms": t_c,
            "ms_per_frame": t_c / chunk,
            "chunk_device_ms": split["total"],
            "chunk_idle_share": 1.0 - split["total"] / t_c,
            "chunk_extract_device_ms": extract,
            "chunk_match_device_ms": split.get("match", 0.0),
            "chunk_rest_device_ms": (split["total"] - extract
                                     - split.get("match", 0.0)),
            "chunk_device_split_ms": split,
            "tracked_frac": float(s[:, 3].mean()),
        }
        print(f"turn {turn} {path}: guided match {t_m:.4f} ms device; "
              f"tracked chunk {t_c:.3f} ms wall ({t_c / chunk:.4f} "
              f"ms/frame), {split['total']:.3f} ms device (extract "
              f"{extract:.3f}, match {split.get('match', 0.0):.3f}, "
              f"unattributed {split['unattributed']:.3f}), tracked "
              f"{s[:, 3].mean():.3f}  [{card}]", flush=True)

    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=2))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
