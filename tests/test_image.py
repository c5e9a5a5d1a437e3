import numpy as np
import jax.numpy as jnp

from tinyslam.ops import (
    rgb_to_gray,
    downsample2x,
    gaussian_blur,
    gaussian_kernel,
    build_pyramid,
)


def test_gray_rec601():
    rgb = jnp.asarray([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    g = np.asarray(rgb_to_gray(rgb))
    np.testing.assert_allclose(g[0], [0.299, 0.587, 0.114], atol=1e-6)


def test_gray_uint8():
    rgb = jnp.full((4, 4, 3), 255, jnp.uint8)
    np.testing.assert_allclose(np.asarray(rgb_to_gray(rgb)), 1.0, atol=1e-5)


def test_downsample_average():
    img = jnp.asarray(np.arange(16, dtype=np.float32).reshape(4, 4))
    d = np.asarray(downsample2x(img))
    want = np.array([[(0 + 1 + 4 + 5) / 4, (2 + 3 + 6 + 7) / 4],
                     [(8 + 9 + 12 + 13) / 4, (10 + 11 + 14 + 15) / 4]])
    np.testing.assert_allclose(d, want)


def test_blur_golden():
    rng = np.random.default_rng(0)
    img = rng.random((16, 24)).astype(np.float32)
    taps = gaussian_kernel(2.0, 3)
    # Naive 2D edge-padded convolution.
    p = np.pad(img, 3, mode="edge")
    want = np.zeros_like(img)
    for dy in range(7):
        for dx in range(7):
            want += taps[dy] * taps[dx] * p[dy : dy + 16, dx : dx + 24]
    got = np.asarray(gaussian_blur(jnp.asarray(img), 2.0))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_blur_actually_blurs_both_axes():
    # Regression vs reference bug #2 (Y pipeline built from the X shader):
    # an impulse must spread along BOTH axes.
    img = np.zeros((15, 15), np.float32)
    img[7, 7] = 1.0
    out = np.asarray(gaussian_blur(jnp.asarray(img), 2.0))
    assert out[5, 7] > 1e-3 and out[7, 5] > 1e-3
    np.testing.assert_allclose(out[5, 7], out[7, 5], atol=1e-6)
    np.testing.assert_allclose(out.sum(), 1.0, atol=1e-4)


def test_pyramid_shapes():
    g = jnp.zeros((64, 96))
    levels, blurred = build_pyramid(g, 3)
    assert [l.shape for l in levels] == [(64, 96), (32, 48), (16, 24)]
    assert [b.shape for b in blurred] == [(64, 96), (32, 48), (16, 24)]


def test_textured_room_clutter_renders_and_occludes():
    """Interior clutter boxes: rendered, nearest-hit (occluding the walls),
    and consistent with the ground-truth raycast."""
    import numpy as np

    from tinyslam.data.synthetic import TexturedRoom, look_at
    from tinyslam.geometry.camera import PinholeCamera

    rng = np.random.default_rng(2)
    room = TexturedRoom(rng, tex_res=64, octaves=2, clutter=5)
    assert len(room.boxes) == 5
    cam = PinholeCamera.create(fx=200.0, fy=200.0, cx=159.5, cy=119.5)
    R, t = look_at(np.array([0.0, 0.0, -2.0]), np.array([0.0, 0.0, 6.0]))
    img_c = room.render(cam, np.asarray(R), np.asarray(t), 320, 240)
    room2 = TexturedRoom(np.random.default_rng(2), tex_res=64, octaves=2)
    img_p = room2.render(cam, np.asarray(R), np.asarray(t), 320, 240)
    # Clutter must change a nontrivial part of the image (occlusion).
    frac = np.mean(np.abs(img_c - img_p) > 1e-6)
    assert 0.005 < frac < 0.9, frac
    # Raycast depth at a changed pixel must be NEARER than the bare room's.
    ys, xs = np.nonzero(np.abs(img_c - img_p) > 1e-6)
    uv = np.stack([xs[:50], ys[:50]], -1).astype(np.float64)
    P_c = room.raycast(cam, np.asarray(R), np.asarray(t), uv)
    P_p = room2.raycast(cam, np.asarray(R), np.asarray(t), uv)
    C = -np.asarray(R).T @ np.asarray(t)
    d_c = np.linalg.norm(P_c - C, axis=-1)
    d_p = np.linalg.norm(P_p - C, axis=-1)
    assert np.all(d_c <= d_p + 1e-6)
