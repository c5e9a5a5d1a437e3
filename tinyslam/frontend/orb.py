"""The ORB front-end pipeline: frame in, oriented-FAST + rBRIEF features out.

The device-side equivalent of the reference's per-frame hot path
(reference src/orb.rs:469-557 `extract_corners`): grayscale -> image pyramid
(downsample + correct separable blur) -> FAST score maps per octave -> top-k
compaction -> steered BRIEF.  Where the reference records render/compute
passes into a command encoder and round-trips the CPU every frame
(orb.rs:541-547), here the whole pipeline is ONE jitted pure function over
static shapes; frames stay device-resident and only the compact Features
pytree ever needs to reach the host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinyslam.config import FrontendConfig
from tinyslam.ops import (
    brief_descriptors,
    build_pyramid,
    fast_score_map,
    rgb_to_gray,
    select_topk,
)
from tinyslam.ops.fast import nms3x3
from tinyslam.types import Features


def extract_features(
    image: jax.Array,
    threshold: jax.Array | float,
    cfg: FrontendConfig,
) -> Features:
    """Pure function: (H, W[, 3]) image -> Features with capacity
    cfg.features_per_level * cfg.num_levels.

    `threshold` is a traced argument — the reference's one runtime knob
    (orb.rs:585-589 set_threshold) without retracing.
    """
    if image.dtype == jnp.uint8:
        image = image.astype(jnp.float32) * (1.0 / 255.0)
    gray = rgb_to_gray(image) if image.ndim == 3 else image.astype(jnp.float32)

    # Static slices of edge-padded arrays throughout (ops/fast.py,
    # ops/image.py): XLA fuses the blur, FAST score, NMS and moments of a
    # level into a few loop fusions.
    levels, blurred = build_pyramid(gray, cfg.num_levels, cfg.blur_sigma)

    parts: list[Features] = []
    for lvl in range(cfg.num_levels):
        with jax.named_scope(f"orb_level{lvl}"):
            with jax.named_scope("fast"):
                score_raw, m10, m01 = fast_score_map(
                    levels[lvl], threshold, cfg.border, cfg.streak_length
                )
            with jax.named_scope("nms"):
                score = nms3x3(score_raw) if cfg.nms else score_raw
            with jax.named_scope("topk"):
                sel = select_topk(score, score_raw, m10, m01,
                                  cfg.features_per_level)
            with jax.named_scope("brief"):
                if cfg.brief_bins > 0 and not cfg.interpolate_descriptors:
                    from tinyslam.ops.brief import brief_descriptors_binned

                    desc = brief_descriptors_binned(
                        blurred[lvl],
                        sel["xy"],
                        sel["angle"],
                        sel["valid"],
                        bins=cfg.brief_bins,
                    )
                else:
                    desc = brief_descriptors(
                        blurred[lvl],
                        sel["xy"],
                        sel["angle"],
                        sel["valid"],
                        interpolate=cfg.interpolate_descriptors,
                    )
            scale = jnp.float32(1 << lvl)
            parts.append(
                Features(
                    xy=sel["xy"] * scale,  # level-0 pixel coords
                    level=jnp.full((cfg.features_per_level,), lvl, jnp.int32),
                    angle=sel["angle"],
                    score=sel["score"],
                    desc=desc,
                    valid=sel["valid"],
                )
            )
    return Features.concatenate(parts)


def adapt_threshold(
    threshold: jax.Array, count: jax.Array, capacity: int, target: float
) -> jax.Array:
    """Device-side multiplicative threshold controller (no host sync).

    Nudges the FAST threshold so the detected/capacity fill ratio tracks
    ``target`` — the controller the reference's ``initial_threshold`` naming
    implies but never built (orb.rs:44; set_threshold orb.rs:585-589 is the
    manual version).  The two branches are mutually exclusive, so the chained
    ``where`` is an if/elif.
    """
    fill = count.astype(jnp.float32) / capacity
    th = jnp.where(
        fill > min(0.99, target * 1.2),
        jnp.minimum(threshold * 1.1, 0.5),
        threshold,
    )
    th = jnp.where(fill < target * 0.8, jnp.maximum(th * 0.9, 0.01), th)
    return th


class OrbFrontend:
    """Config-bound, jit-compiled front-end.

    Usage::

        fe = OrbFrontend(FrontendConfig(height=480, width=640))
        feats = fe.extract(frame)            # compiled once per image shape
        feats = fe.extract(frame, threshold=0.08)

    Adaptive thresholding (cfg.adaptive_threshold) runs ENTIRELY on device:
    the threshold lives as a device scalar that each extraction returns
    updated; the host never reads ``feats.count`` (a per-frame device->host
    sync would cap async dispatch — the disease the reference has at
    orb.rs:541-547, one blocking readback per frame).
    """

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg
        self._extract = jax.jit(
            functools.partial(extract_features, cfg=cfg)
        )

        def _extract_adaptive(image, threshold):
            feats = extract_features(image, threshold, cfg)
            new_t = adapt_threshold(
                threshold, feats.count, cfg.max_features, cfg.target_fill
            )
            return feats, new_t

        self._extract_adaptive = jax.jit(_extract_adaptive)
        self._threshold = jnp.float32(cfg.threshold)  # device scalar

    @property
    def threshold(self) -> float:
        """Current FAST threshold (forces a device sync; debugging/ckpt only)."""
        return float(self._threshold)

    @threshold.setter
    def threshold(self, value: float) -> None:
        self._threshold = jnp.float32(value)

    def extract(self, image: jax.Array, threshold: float | None = None) -> Features:
        if threshold is not None:
            return self._extract(image, jnp.float32(threshold))
        if self.cfg.adaptive_threshold:
            feats, self._threshold = self._extract_adaptive(
                image, self._threshold)
            return feats
        return self._extract(image, self._threshold)
