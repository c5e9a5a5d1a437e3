"""Train a decorrelated BRIEF-256 pair pattern (VERDICT r3 next-step #6).

The reference ships the classic learned ORB table (reference
src/shaders/brief.wgsl:70-327); round 1-3 deliberately used random Gaussian
pairs instead.  Random pairs are self-consistent but their bits correlate
(nearby pairs answer the same question), wasting descriptor entropy —
and matching quality is upstream of the ATE target.  This tool re-derives a
decorrelated pattern with the ORB paper's greedy procedure on OUR OWN data
(rendered textured-room corners through our FAST detector), not by copying
the reference's constants:

  1. detect FAST corners on rendered frames; cut blurred 31x31 patches,
     rotated to each corner's orientation (the steered setting is what the
     bits will live in);
  2. candidate pool = a large set of Gaussian pairs (the same sampler the
     random pattern uses, so the comparison isolates SELECTION);
  3. compute each candidate's bit over all patches; greedily keep
     candidates whose mean is nearest 0.5 and whose max |correlation| with
     every kept bit is below a threshold, relaxing the threshold until 256
     survive.

Writes tinyslam/ops/brief_pattern_learned.py (int32 literal) and
prints before/after bit statistics.

    python tools/train_brief_pattern.py [--patches 40000] [--pool 3072]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def collect_patches(n_target: int, rng: np.random.Generator) -> np.ndarray:
    """(P, 31, 31) float32 blurred patches around detected FAST corners,
    rotated to the corner orientation."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tinyslam.config import FrontendConfig
    from tinyslam.data.synthetic import (
        TexturedRoom, handheld_trajectory, render_sequence,
    )
    from tinyslam.data.tum import FR1_INTRINSICS
    from tinyslam.frontend.orb import extract_features
    from tinyslam.geometry.camera import PinholeCamera
    from tinyslam.ops.image import build_pyramid, rgb_to_gray

    cam = PinholeCamera.create(**FR1_INTRINSICS)
    cfg = FrontendConfig()
    import functools
    extract = jax.jit(functools.partial(extract_features, cfg=cfg))
    pyramid = jax.jit(functools.partial(build_pyramid, num_levels=1,
                                        blur_sigma=cfg.blur_sigma))
    out = []
    scene = 0
    R = 15
    while sum(p.shape[0] for p in out) < n_target:
        room = TexturedRoom(rng, tex_res=256, octaves=4)
        poses = handheld_trajectory(rng, 8)
        frames = render_sequence(rng, poses, cam, 640, 480, room, dist=None)
        for img in frames:
            g = np.asarray(img, np.float32)
            if g.ndim == 3:
                g = np.asarray(rgb_to_gray(jnp.asarray(g / 255.0 if g.max() > 2
                                                       else g)))
            elif g.max() > 2:
                g = g / 255.0
            feats = extract(jnp.asarray(g), cfg.threshold)
            _, blurred = pyramid(jnp.asarray(g))
            B = np.asarray(blurred[0])
            xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
            ang = np.asarray(feats.angle)[np.asarray(feats.valid)]
            lv = np.asarray(feats.level)[np.asarray(feats.valid)]
            xy, ang = xy[lv == 0], ang[lv == 0]
            h, w = B.shape
            # Rotated patch sample grid (31x31 at the corner orientation).
            ys, xs = np.mgrid[-R:R + 1, -R:R + 1]
            for (x0, y0), a in zip(xy, ang):
                c, s = np.cos(a), np.sin(a)
                rx = np.rint(c * xs - s * ys + x0).astype(int)
                ry = np.rint(s * xs + c * ys + y0).astype(int)
                if (rx.min() < 0 or ry.min() < 0 or rx.max() >= w
                        or ry.max() >= h):
                    continue
                out.append(B[ry, rx][None])
        scene += 1
        print(f"scene {scene}: {sum(p.shape[0] for p in out)} patches",
              flush=True)
    return np.concatenate(out)[:n_target]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patches", type=int, default=30000)
    ap.add_argument("--pool", type=int, default=3072)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()

    from tinyslam.ops.brief import PATCH_RADIUS

    rng = np.random.default_rng(args.seed)
    patches = collect_patches(args.patches, rng)          # (P, 31, 31)
    P = patches.shape[0]
    print(f"{P} patches", flush=True)

    # Candidate pool: same Gaussian sampler as the shipped random pattern.
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pool = np.clip(np.rint(rng.normal(0, sigma, size=(args.pool, 2, 2))),
                   -PATCH_RADIUS, PATCH_RADIUS).astype(np.int32)
    keep = ~np.all(pool[:, 0] == pool[:, 1], axis=-1)
    pool = pool[keep]

    # Bits of every candidate over every patch.
    def bits_of(pat):
        a = patches[:, pat[:, 0, 1] + PATCH_RADIUS + 2,
                    pat[:, 0, 0] + PATCH_RADIUS + 2]
        b = patches[:, pat[:, 1, 1] + PATCH_RADIUS + 2,
                    pat[:, 1, 0] + PATCH_RADIUS + 2]
        return a > b                                     # (P, M)

    bits = bits_of(pool)
    means = bits.mean(axis=0)
    order = np.argsort(np.abs(means - 0.5))
    bf = (bits.astype(np.float32) - means[None, :])
    norm = np.sqrt((bf * bf).sum(axis=0)) + 1e-9

    thresh = 0.18
    while True:
        sel: list[int] = []
        sel_bf = None
        for i in order:
            if not sel:
                sel.append(i)
                sel_bf = bf[:, [i]]
                continue
            corr = (sel_bf.T @ bf[:, i]) / (norm[sel] * norm[i])
            if np.abs(corr).max() < thresh:
                sel.append(i)
                sel_bf = np.concatenate([sel_bf, bf[:, [i]]], axis=1)
            if len(sel) == 256:
                break
        if len(sel) == 256:
            break
        thresh += 0.02
        print(f"relaxing correlation threshold to {thresh:.2f} "
              f"({len(sel)} selected)", flush=True)

    learned = pool[sel]
    # Statistics: learned vs the shipped random pattern.
    from tinyslam.ops.brief import BRIEF_PATTERN

    def stats(pat, name):
        b = bits_of(pat).astype(np.float32)
        m = b.mean(axis=0)
        bc = b - m[None, :]
        nn = np.sqrt((bc * bc).sum(axis=0)) + 1e-9
        C = (bc.T @ bc) / np.outer(nn, nn)
        np.fill_diagonal(C, 0.0)
        print(f"{name}: mean|m-0.5|={np.abs(m - 0.5).mean():.4f} "
              f"mean|corr|={np.abs(C).mean():.4f} "
              f"max|corr|={np.abs(C).max():.4f}", flush=True)

    stats(np.asarray(BRIEF_PATTERN), "random (shipped)")
    stats(learned, f"learned (thresh={thresh:.2f})")

    dst = REPO / "tinyslam" / "ops" / "brief_pattern_learned.py"
    rows = ",\n".join(
        "    [[%d, %d], [%d, %d]]" % (p[0, 0], p[0, 1], p[1, 0], p[1, 1])
        for p in learned)
    dst.write_text(
        '"""Decorrelated BRIEF-256 pattern, trained by '
        "tools/train_brief_pattern.py\n"
        "on rendered corner patches (ORB-paper greedy selection; NOT the\n"
        'reference\'s bit_pattern_31 — see the tool docstring)."""\n\n'
        "import numpy as np\n\n"
        "LEARNED_PATTERN = np.asarray([\n" + rows + "\n], np.int32)\n")
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
