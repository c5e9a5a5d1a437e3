#!/usr/bin/env python3
"""Smoke test of tinyslam on one GPU: kernels at real widths, then the main
path end to end.

    python chip_smoke.py

Phases (each raises, and the script exits non-zero, on failure):
  a. device: JAX's first device must be a GPU; prints the card's name and
     power limit (nvidia-smi) and the jax/jaxlib versions;
  b. parity at real widths: the fused Triton matcher against the XLA
     reference (bit for bit on valid rows), also with every planted
     projection on the guided gate's edge (one float32 ulp inside, on it,
     one ulp outside); extraction on the GPU against
     the CPU backend at 640x480; BRIEF at its default precision (TF32)
     against HIGHEST;
  c. timing: the matcher kernel against its XLA version at the tracker's
     shapes (wall time to block_until_ready, and device time from a trace);
  d. the main path: ``tinyslam.run.main`` in SLAM mode with the device
     tracker over a rendered 640x480 TUM-format sequence, with bounds on
     the tracked fraction, keyframes and ATE.

The last line of stdout is one JSON object naming the device.  Rendered
frames are kept in .smoke_seq/ (git-ignored), so reruns skip rendering.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEQ_DIR = REPO / ".smoke_seq" / "fr1_desk_like_100"
NUM_FRAMES = 100

# Main-path bounds.
MIN_TRACKED_FRAC = 0.9      # of the frames after bootstrap
MIN_KEYFRAMES = 1
# Parity bounds.
SCORE_ATOL = 1e-5           # FAST score maps, GPU vs CPU backend
MIN_FEATURE_OVERLAP = 0.99  # selected features, GPU vs CPU backend
MAX_BRIEF_BIT_DIFF = 0.01   # descriptor bits, DEFAULT (TF32) vs HIGHEST
# Matcher shapes: per tracked frame (2048 features x 8192 map points,
# guided) and at keyframe insertion (2048 x 2048, unguided).
MATCH_SHAPES = ((2048, 8192, True), (2048, 2048, False))
GATE_RADIUS_PX = 20.0


def require_gpu():
    """The first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX's first device is {dev.platform}")
    return dev


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _match_inputs(rng, n: int, m: int):
    """Descriptors with planted near-copies (matchable), exact duplicates in
    B (argmin ties), invalid slots and a guided-gate geometry."""
    da = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    k = min(n, m) // 2
    flips = rng.random((k, 8, 32)) < 0.03
    noise = np.sum(flips.astype(np.uint32) << np.arange(32, dtype=np.uint32),
                   axis=-1, dtype=np.uint32)
    db[:k] = da[:k] ^ noise
    db[k:k + k // 8] = db[:k // 8]                      # ties
    va = rng.random(n) > 0.05
    vb = rng.random(m) > 0.05
    xy = rng.uniform((0, 0), (640, 480), (n, 2)).astype(np.float32)
    proj = rng.uniform((0, 0), (640, 480), (m, 2)).astype(np.float32)
    proj[:k] = xy[:k] + rng.normal(0, 5, (k, 2)).astype(np.float32)
    return da, va, db, vb, xy, proj


def _on_gate_edge(xy, proj, radius: float):
    """Move the planted projections onto the gate circle: one float32 ulp
    inside, on it or one ulp outside, along an axis or a diagonal."""
    k = min(len(xy), len(proj)) // 2
    r32 = np.float32(radius)
    r = np.array([np.nextafter(r32, np.float32(0)), r32,
                  np.nextafter(r32, np.float32(1e9))])[(np.arange(k) // 4) % 3]
    ang = np.pi / 4 * (np.arange(k) % 4)
    proj = proj.copy()
    proj[:k] = xy[:k] + np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    return proj


def check_matcher(rng) -> dict:
    import jax
    import jax.numpy as jnp

    from tinyslam.config import MatcherConfig
    from tinyslam.ops.hamming import match_descriptors, matcher_path

    mc = MatcherConfig()
    path = matcher_path(mc.max_distance, mc.ratio)
    print(f"matcher path (default config): {path}", flush=True)
    if path != "triton":
        raise RuntimeError(f"expected the Triton matcher on the GPU, got {path}")
    out = {}
    cases = [(n, m, guided, False) for n, m, guided in MATCH_SHAPES]
    cases.append((2048, 8192, True, True))
    for n, m, guided, edge in cases:
        da, va, db, vb, xy, proj = _match_inputs(rng, n, m)
        if edge:
            proj = _on_gate_edge(xy, proj, GATE_RADIUS_PX)
        da, va, db, vb, xy, proj = map(jnp.asarray,
                                       (da, va, db, vb, xy, proj))
        kw = dict(max_distance=mc.max_distance, ratio=mc.ratio)
        if guided:
            kw.update(xy_a=xy, proj_b=proj, radius_px=GATE_RADIUS_PX)
        with jax.default_matmul_precision("highest"):
            ref = match_descriptors(da, va, db, vb, kernel=False, **kw)
        got = match_descriptors(da, va, db, vb, kernel=True, **kw)
        ref, got = jax.device_get((ref, got))
        v = ref["valid"]
        # On the gate's edge about a third of the planted pairs pass it.
        if v.sum() < (n // 20 if edge else n // 10):
            raise RuntimeError(f"matcher parity {n}x{m}: only {v.sum()} "
                               "valid matches, the check has no power")
        for key in ("valid", "idx_b", "dist"):
            a, b = (got[key], ref[key]) if key == "valid" else (
                got[key][v], ref[key][v])
            if not np.array_equal(a, b):
                raise RuntimeError(
                    f"matcher parity {n}x{m} guided={guided} gate_edge={edge}"
                    f": {key} differs in {int(np.sum(a != b))} rows")
        tag = (f"{n}x{m}{'_guided' if guided else ''}"
               f"{'_edge' if edge else ''}")
        out[tag] = int(v.sum())
        print(f"matcher parity {n}x{m} guided={guided} gate_edge={edge}: "
              f"idx_b/dist/valid equal on all {int(v.sum())} valid rows",
              flush=True)
    return out


def check_extract(frame: np.ndarray) -> dict:
    import jax
    import jax.numpy as jnp

    from tinyslam.config import FrontendConfig
    from tinyslam.frontend.orb import extract_features
    from tinyslam.ops import build_pyramid, fast_score_map, select_topk
    from tinyslam.ops.brief import brief_descriptors_binned
    from tinyslam.ops.fast import nms3x3

    cfg = FrontendConfig()
    thr = jnp.float32(cfg.threshold)

    def scores(img):
        levels, _ = build_pyramid(img, cfg.num_levels, cfg.blur_sigma)
        return [fast_score_map(lv, thr, cfg.border, cfg.streak_length)[0]
                for lv in levels]

    def extract(img):
        return extract_features(img, thr, cfg)

    gray = frame.astype(np.float32) / 255.0
    cpu = jax.devices("cpu")[0]
    g_scores, g_feats = jax.device_get(
        (jax.jit(scores)(gray), jax.jit(extract)(gray)))
    with jax.default_device(cpu):
        gc = jax.device_put(gray, cpu)
        c_scores, c_feats = jax.device_get(
            (jax.jit(scores)(gc), jax.jit(extract)(gc)))
    worst = max(float(np.max(np.abs(g - c)))
                for g, c in zip(g_scores, c_scores))
    if worst > SCORE_ATOL:
        raise RuntimeError(f"FAST score maps GPU vs CPU differ by {worst}")

    # Selected-feature overlap: a CPU feature is found when the GPU selected
    # one at the same level within 0.05 px.
    found = total = 0
    for lvl in range(cfg.num_levels):
        sel_c = (c_feats.level == lvl) & c_feats.valid
        sel_g = (g_feats.level == lvl) & g_feats.valid
        xc, xg = c_feats.xy[sel_c], g_feats.xy[sel_g]
        total += len(xc)
        if len(xc) and len(xg):
            d = np.linalg.norm(xc[:, None] - xg[None], axis=-1)
            found += int(np.sum(d.min(axis=1) < 0.05))
    overlap = found / max(total, 1)
    if total == 0 or overlap < MIN_FEATURE_OVERLAP:
        raise RuntimeError(f"feature overlap GPU vs CPU {overlap} "
                           f"({found}/{total})")

    # BRIEF at the default precision (TF32 on this card) vs HIGHEST, on the
    # GPU's own selection.
    def brief(img, precision):
        levels, blurred = build_pyramid(img, cfg.num_levels, cfg.blur_sigma)
        out = []
        for lv, bl in zip(levels, blurred):
            s, m10, m01 = fast_score_map(lv, thr, cfg.border, cfg.streak_length)
            sel = select_topk(nms3x3(s), s, m10, m01, cfg.features_per_level)
            out.append((brief_descriptors_binned(
                bl, sel["xy"], sel["angle"], sel["valid"], bins=cfg.brief_bins,
                precision=precision), sel["valid"]))
        return out

    d_def = jax.device_get(jax.jit(
        lambda im: brief(im, jax.lax.Precision.DEFAULT))(gray))
    d_hi = jax.device_get(jax.jit(
        lambda im: brief(im, jax.lax.Precision.HIGHEST))(gray))
    diff_bits = n_bits = 0
    for (a, va), (b, _) in zip(d_def, d_hi):
        x = np.bitwise_xor(a[va], b[va])
        diff_bits += int(np.unpackbits(x.view(np.uint8)).sum())
        n_bits += int(va.sum()) * 256
    brief_diff = diff_bits / max(n_bits, 1)
    if brief_diff > MAX_BRIEF_BIT_DIFF:
        raise RuntimeError(f"BRIEF DEFAULT vs HIGHEST: {brief_diff:.4%} of "
                           "bits differ")
    print(f"extract parity 640x480: score max|GPU-CPU|={worst:.3g} "
          f"(bound {SCORE_ATOL}), feature overlap {overlap:.4f} "
          f"({found}/{total}, bound {MIN_FEATURE_OVERLAP}), BRIEF "
          f"DEFAULT-vs-HIGHEST bit disagreement {brief_diff:.5f} "
          f"(bound {MAX_BRIEF_BIT_DIFF})", flush=True)
    return {"score_max_abs_diff": worst, "feature_overlap": overlap,
            "brief_bit_diff": brief_diff}


def time_matcher(rng, card: str) -> dict:
    """Matcher kernel against its XLA version: wall ms per call (to
    block_until_ready, host dispatch included) and device ms per call (from
    a trace)."""
    import jax
    import jax.numpy as jnp

    from tinyslam.config import MatcherConfig
    from tinyslam.ops.hamming import match_descriptors
    from tinyslam.utils.profiling import device_seconds_per_call, time_call

    mc = MatcherConfig()
    out = {}
    for n, m, guided in MATCH_SHAPES:
        args = tuple(map(jnp.asarray, _match_inputs(rng, n, m)))
        row = {}
        for path, kernel in (("triton", True), ("xla", False)):
            fn = jax.jit(lambda da, va, db, vb, xy, proj, kernel=kernel:
                         match_descriptors(
                             da, va, db, vb, kernel=kernel,
                             max_distance=mc.max_distance, ratio=mc.ratio,
                             **(dict(xy_a=xy, proj_b=proj,
                                     radius_px=GATE_RADIUS_PX)
                                if guided else {})))
            row[f"{path}_wall_ms"] = time_call(fn, [args], reps=30) * 1e3
            row[f"{path}_device_ms"] = (
                device_seconds_per_call(fn, args)["total"] * 1e3)
        key = f"{n}x{m}{'_guided' if guided else ''}"
        out[key] = row
        print(f"matcher {key}: device triton {row['triton_device_ms']:.4f} "
              f"ms vs xla {row['xla_device_ms']:.4f} ms; wall (dispatch "
              f"included) triton {row['triton_wall_ms']:.4f} ms vs xla "
              f"{row['xla_wall_ms']:.4f} ms  [{card}]", flush=True)
    return out


def render_sequence() -> Path:
    """Render the fr1_desk-like sequence (TUM layout, fr1 intrinsics and
    lens distortion, photometric effects) unless it is already on disk."""
    if (SEQ_DIR / "rgb.txt").exists():
        return SEQ_DIR
    sys.path.insert(0, str(REPO / "tools"))
    from eval_ate import build_fr1_desk_like

    t0 = time.time()
    SEQ_DIR.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=SEQ_DIR.parent))   # renamed when complete
    build_fr1_desk_like(tmp, NUM_FRAMES)
    tmp.rename(SEQ_DIR)
    print(f"rendered {NUM_FRAMES} frames in {time.time() - t0:.1f} s",
          flush=True)
    return SEQ_DIR


def run_main_path(seq: Path) -> dict:
    from tinyslam.run import main as run_main

    out = SEQ_DIR.parent / "summary.json"
    t0 = time.time()
    rc = run_main(["--dataset", "tum", "--root", str(seq), "--mode", "slam",
                   "--tracker", "device", "--summary", str(out)])
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"run.main returned {rc}")
    s = json.loads(out.read_text())
    print(f"main path: frames={s['frames']} bootstrap={s['bootstrap_frames']} "
          f"tracked_frac_after_bootstrap={s['tracked_frac_after_bootstrap']:.4f}"
          f" keyframes={s['keyframes']} ate_sim3_m={s['ate_sim3_m']} "
          f"wall_fps_incl_compile={s['fps_incl_compile']:.3f} "
          f"(compile included, {wall:.1f} s)", flush=True)
    if s["frames"] < NUM_FRAMES:
        raise RuntimeError(f"main path ran {s['frames']} < {NUM_FRAMES} frames")
    if s["tracked_frac_after_bootstrap"] < MIN_TRACKED_FRAC:
        raise RuntimeError(
            f"tracked fraction {s['tracked_frac_after_bootstrap']} < "
            f"{MIN_TRACKED_FRAC}")
    if s["keyframes"] < MIN_KEYFRAMES:
        raise RuntimeError(f"{s['keyframes']} keyframes < {MIN_KEYFRAMES}")
    if s["ate_sim3_m"] is None or not np.isfinite(s["ate_sim3_m"]):
        raise RuntimeError(f"ATE is not finite: {s['ate_sim3_m']}")
    return s


def main() -> int:
    # The package first: outside a checkout this fails before any output.
    from tinyslam.utils.cache import enable_compilation_cache

    dev = require_gpu()
    import jax
    import jaxlib

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
          f"device_kind={dev.device_kind} count={len(jax.devices())}",
          flush=True)
    enable_compilation_cache()
    rng = np.random.default_rng(0)

    seq = render_sequence()
    from tinyslam.data.tum import TumSequence

    _, frame = next(iter(TumSequence.open(seq).frames()))
    check_matcher(rng)
    check_extract(np.asarray(frame))   # a (480, 640) uint8 gray frame
    time_matcher(rng, card)
    run_main_path(seq)

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
