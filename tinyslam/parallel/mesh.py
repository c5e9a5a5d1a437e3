"""Device-mesh construction and multi-host runtime helpers.

Axis conventions (MeshConfig):
  frame    — data parallelism over frames / RANSAC hypothesis batches.
  landmark — map/landmark-block sharding for distributed BA (psum over the mesh).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from tinyslam.config import MeshConfig


def make_mesh(cfg: MeshConfig | None = None,
              devices: list | None = None) -> Mesh:
    """Build a (frame, landmark) mesh.  With no config, all devices go to
    the landmark axis (distributed BA is the communication-bound stage)."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if cfg is None:
        fa, la = 1, n
    else:
        fa, la = cfg.frame_axis, cfg.landmark_axis
        if fa * la != n:
            # Fall back gracefully: put the remainder on the landmark axis.
            fa = min(fa, n)
            la = n // fa
    arr = np.asarray(devices[: fa * la]).reshape(fa, la)
    return Mesh(arr, ("frame", "landmark"))


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (jax.distributed) — JAX's own
    replacement for an MPI bootstrap (SURVEY §2d).  No-op when JAX is
    already initialized or args are absent (single-host)."""
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
