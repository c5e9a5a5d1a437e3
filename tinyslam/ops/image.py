"""Image ops: grayscale, pyramid downsample, separable Gaussian blur.

Replacements for the reference's fullscreen-triangle fragment passes
(reference src/shaders/grayscale.wgsl, blit.wgsl, gaussian_blur_x/_y.wgsl;
recorded per frame at orb.rs:478-498, 411-467).  Here they are dense
elementwise/reduction ops that XLA fuses; no resource graph or render
passes needed.

Bug fixes vs the reference (SURVEY.md §2a):
  - Rec.601 luma uses 0.299 (grayscale.wgsl:36 has a 0.229 typo).
  - Blur offsets are applied in pixel space (the reference adds pixel offsets
    to normalized texcoords, gaussian_blur_x.wgsl:55-57, clamping to the edge).
  - The Y blur really blurs in Y (the reference builds the Y pipeline from the
    X shader module, orb.rs:399-408).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Rec.601 luminance coefficients (reference grayscale.wgsl:36, typo corrected).
LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: jax.Array) -> jax.Array:
    """(..., H, W, 3|4) RGB[A] -> (..., H, W) float32 luminance in [0, 1].

    Accepts uint8 (scaled by 1/255) or float input.  A 4th (alpha) channel is
    dropped — the reference's input texture is Rgba8Unorm (reference
    src/orb.rs:116-121; grayscale.wgsl samples .rgb only).
    """
    if rgb.dtype == jnp.uint8:
        rgb = rgb.astype(jnp.float32) / 255.0
    if rgb.shape[-1] == 4:
        rgb = rgb[..., :3]
    w = jnp.asarray(LUMA, dtype=jnp.float32)
    return jnp.tensordot(rgb.astype(jnp.float32), w, axes=((-1,), (0,)))


def downsample2x(img: jax.Array) -> jax.Array:
    """(..., H, W) -> (..., H//2, W//2) by 2x2 average.

    Equivalent to the reference's linear-sampled blit at pixel centers
    (blit.wgsl, the wgpu mipmap example): a bilinear tap at the midpoint of a
    2x2 quad is exactly its average.
    """
    *b, h, w = img.shape
    h2, w2 = h // 2, w // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*b, h2, 2, w2, 2)
    return x.mean(axis=(-3, -1))


def gaussian_kernel(sigma: float, radius: int = 3) -> np.ndarray:
    """Normalized 1D Gaussian taps of width 2*radius+1 (default 7-tap, as ORB)."""
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d_axis(img: jax.Array, taps: np.ndarray, axis: int) -> jax.Array:
    """Edge-padded 1D convolution along `axis` as a sum of shifted slices.

    A 7-tap 1D filter as 7 fused multiply-adds needs no conv layout
    round-trip; XLA fuses the whole chain into one loop fusion.
    Edge padding reproduces the reference sampler's clamp-to-edge addressing
    (orb.rs:129-131) — which is also the correct choice near borders.
    """
    r = (len(taps) - 1) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    p = jnp.pad(img, pad, mode="edge")
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        sl = jax.lax.slice_in_dim(p, i, i + n, axis=axis)
        term = sl * jnp.float32(t)
        out = term if out is None else out + term
    return out


def gaussian_blur(img: jax.Array, sigma: float = 2.0, radius: int = 3) -> jax.Array:
    """Separable Gaussian blur over the last two axes (X pass then Y pass,
    matching the reference's two-pass structure, orb.rs:432-466, correctly)."""
    taps = gaussian_kernel(sigma, radius)
    out = _conv1d_axis(img, taps, axis=img.ndim - 1)
    out = _conv1d_axis(out, taps, axis=img.ndim - 2)
    return out


def build_pyramid(
    gray: jax.Array, num_levels: int, blur_sigma: float = 2.0
) -> tuple[list[jax.Array], list[jax.Array]]:
    """Build the image + blurred pyramids.

    Returns (levels, blurred): level n has shape (..., H/2^n, W/2^n).
    FAST reads `levels` (reference image_hierarchy, orb.rs:224-236); BRIEF
    reads `blurred` (reference blur_hierarchy, orb.rs:292-319).
    """
    levels = [gray]
    with jax.named_scope("downsample"):
        for n in range(1, num_levels):
            with jax.named_scope(f"orb_level{n}"):
                levels.append(downsample2x(levels[-1]))
    blurred = []
    with jax.named_scope("blur"):
        for n, lv in enumerate(levels):
            with jax.named_scope(f"orb_level{n}"):
                blurred.append(gaussian_blur(lv, blur_sigma))
    return levels, blurred
