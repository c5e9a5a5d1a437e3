"""Pinhole camera model.

Convention: world points X_w; camera pose (R, t) maps world -> camera:
X_c = R X_w + t.  Pixels u = K pi(X_c) with pi the perspective division.
Radial distortion is handled at dataset load time (images are undistorted /
intrinsics adjusted there), keeping the device-side model linear.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinyslam.types import pytree_dataclass


@pytree_dataclass
class PinholeCamera:
    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array

    @staticmethod
    def create(fx, fy, cx, cy) -> "PinholeCamera":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return PinholeCamera(f(fx), f(fy), f(cx), f(cy))

    @property
    def K(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            axis=-2,
        )

    def project(self, xc: jax.Array, eps: float = 1e-6) -> tuple[jax.Array, jax.Array]:
        """Camera-frame points (..., 3) -> pixels (..., 2), plus a validity
        mask (point in front of the camera)."""
        z = xc[..., 2]
        valid = z > eps
        zs = jnp.where(valid, z, 1.0)
        u = self.fx * xc[..., 0] / zs + self.cx
        v = self.fy * xc[..., 1] / zs + self.cy
        return jnp.stack([u, v], axis=-1), valid

    def backproject(self, uv: jax.Array) -> jax.Array:
        """Pixels (..., 2) -> unit-depth camera rays (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)

    def normalize(self, uv: jax.Array) -> jax.Array:
        """Pixels -> normalized image coordinates (x/z, y/z)."""
        return self.backproject(uv)[..., :2]
