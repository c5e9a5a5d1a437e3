"""Core pytree types.

The reference's feature types are CPU-side PODs mirroring GPU structs
(CornerData / CornerDescriptor, reference src/orb.rs:10-38, 16 B + 256-bit).
Here features are a struct-of-arrays pytree with a fixed capacity and a valid
mask — the device-resident version of the reference's ``max_features``
buffer + returned ``corner_count`` contract (orb.rs:550-556).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass whose fields are all pytree children.

    ``jax.tree_util.register_dataclass`` makes instances flatten to their
    fields in declaration order, so they pass through ``jit``, ``scan``,
    ``cond`` and ``jax.tree.map``; ``.replace(**fields)`` returns a copy.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class Features:
    """A fixed-capacity batch of ORB features.

    Attributes:
      xy:    (N, 2) float32 — (x, y) pixel coords at pyramid level 0 scale.
      level: (N,)   int32   — pyramid octave the feature was detected at
                              (reference fast.wgsl:20 push-constant `octave`).
      angle: (N,)   float32 — orientation in radians from the intensity
                              centroid (reference fast.wgsl:115).  Full
                              [-pi, pi]; the reference's u32(angle*1000)
                              encoding collapsed negatives (SURVEY §2a bug 3).
      score: (N,)   float32 — FAST corner score (0 for invalid slots).
      desc:  (N, 8) uint32  — 256-bit steered BRIEF, bit (w*32+i) of word w
                              (reference brief.wgsl:43-67 layout).
      valid: (N,)   bool    — slot validity mask (the `corner_count` analog).
    """

    xy: jax.Array
    level: jax.Array
    angle: jax.Array
    score: jax.Array
    desc: jax.Array
    valid: jax.Array

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)

    @staticmethod
    def empty(capacity: int) -> "Features":
        return Features(
            xy=jnp.zeros((capacity, 2), jnp.float32),
            level=jnp.zeros((capacity,), jnp.int32),
            angle=jnp.zeros((capacity,), jnp.float32),
            score=jnp.zeros((capacity,), jnp.float32),
            desc=jnp.zeros((capacity, 8), jnp.uint32),
            valid=jnp.zeros((capacity,), bool),
        )

    @staticmethod
    def concatenate(parts: list["Features"]) -> "Features":
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


@pytree_dataclass
class Frame:
    """One input frame: image plus (optional) metadata."""

    rgb: jax.Array          # (H, W, 3) float32 in [0, 1] or uint8
    timestamp: jax.Array    # () float64/float32 seconds


def unpack_descriptor_bits(desc: jax.Array) -> jax.Array:
    """(N, 8) uint32 packed -> (N, 256) {0,1} int8 bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts[None, :]) & jnp.uint32(1)
    return bits.reshape(*desc.shape[:-1], 256).astype(jnp.int8)


def pack_descriptor_bits(bits: jax.Array) -> jax.Array:
    """(N, 256) {0,1} -> (N, 8) uint32 packed (bit w*32+i -> word w bit i)."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def descriptor_signs(desc: jax.Array) -> jax.Array:
    """(N, 8) packed -> (N, 256) int8 in {-1, +1} for matmul Hamming matching.

    hamming(a, b) = (256 - signs(a) @ signs(b)) / 2 — one int8 dot_general
    on the tensor cores (SURVEY §7 'Matching -> matrix unit').
    """
    return (unpack_descriptor_bits(desc) * 2 - 1).astype(jnp.int8)
