"""Frame data parallelism for the ORB front-end.

The front-end is embarrassingly parallel per frame (SURVEY §2d): a batch of
frames shards over the mesh `frame` axis via NamedSharding and the jitted
vmapped extractor runs with zero cross-device communication — XLA partitions
it automatically (GSPMD), no shard_map needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tinyslam.config import FrontendConfig
from tinyslam.frontend.orb import extract_features
from tinyslam.types import Features


@functools.partial(jax.jit, static_argnames=("cfg",))
def _extract_batch(images: jax.Array, threshold: jax.Array,
                   cfg: FrontendConfig) -> Features:
    return jax.vmap(lambda im: extract_features(im, threshold, cfg))(images)


def extract_features_batch(
    images: jax.Array,
    threshold: float,
    cfg: FrontendConfig,
    mesh: Mesh | None = None,
) -> Features:
    """Extract features from a batch of frames, optionally sharded.

    images: (B, H, W) or (B, H, W, 3).  With a mesh, the batch axis shards
    over `frame` and outputs come back with the same sharding (device-
    resident, ready for downstream sharded matching).
    """
    t = jnp.float32(threshold)
    if mesh is None:
        return _extract_batch(images, t, cfg)
    sharding = NamedSharding(mesh, P("frame"))
    images = jax.device_put(images, sharding)
    with mesh:
        return _extract_batch(images, t, cfg)
