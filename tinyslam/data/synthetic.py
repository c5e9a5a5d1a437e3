"""Synthetic scenes, trajectories and rendered frames.

Ground-truth generators used by the geometry/BA/VO tests and benchmarks
(the reference has no datasets or tests at all — SURVEY §4; this module is
the in-repo stand-in for TUM/EuRoC sequences in environments without the
datasets on disk).
"""

from __future__ import annotations

import numpy as np

from tinyslam.geometry.camera import PinholeCamera

import jax.numpy as jnp


def default_camera(width: int = 640, height: int = 480) -> PinholeCamera:
    """TUM-fr1-like intrinsics."""
    return PinholeCamera.create(
        fx=517.3, fy=516.5, cx=width / 2 - 0.5, cy=height / 2 - 0.5
    )


def random_points(rng: np.random.Generator, n: int,
                  center=(0.0, 0.0, 0.0), extent=(4.0, 3.0, 2.0)) -> np.ndarray:
    c = np.asarray(center)
    e = np.asarray(extent)
    return (rng.random((n, 3)) - 0.5) * e + c


def look_at(camera_pos: np.ndarray, target: np.ndarray,
            up=(0.0, -1.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """World->camera (R, t) for a camera at `camera_pos` looking at `target`.
    Camera convention: +z forward, +x right, +y down (image coords)."""
    fwd = target - camera_pos
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(upv, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # looking along up: pick another up
        upv = np.array([1.0, 0.0, 0.0])
        right = np.cross(upv, fwd)
        nr = np.linalg.norm(right)
    right /= nr
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ camera_pos
    return R.astype(np.float32), t.astype(np.float32)


def orbit_trajectory(num_frames: int, radius: float = 6.0,
                     height: float = 0.5, arc: float = 0.8,
                     target=(0.0, 0.0, 0.0),
                     start: float | None = None,
                     step: float | None = None) -> list[tuple[np.ndarray, np.ndarray]]:
    """Cameras on a horizontal arc, all looking at `target`.

    Either give `arc` (total sweep, centered) or `step` + `start` (fixed
    per-frame angle — sequence prefix independent of num_frames)."""
    poses = []
    tgt = np.asarray(target, np.float64)
    for i in range(num_frames):
        if step is not None:
            a = (start or 0.0) + i * step
        else:
            a = (i / max(num_frames - 1, 1) - 0.5) * arc
        pos = np.array([radius * np.sin(a), height, -radius * np.cos(a)]) + tgt
        poses.append(look_at(pos, tgt))
    return poses


def project_points(cam: PinholeCamera, R: np.ndarray, t: np.ndarray,
                   X: np.ndarray, width: int = 640, height: int = 480,
                   noise_px: float = 0.0, outlier_frac: float = 0.0,
                   rng: np.random.Generator | None = None):
    """Project world points; returns (uv (N,2), visible (N,) bool).
    Optionally perturbs with Gaussian pixel noise and replaces a fraction
    with uniform outliers (still marked visible — that's the point)."""
    rng = rng or np.random.default_rng(0)
    Xc = X @ np.asarray(R).T + np.asarray(t)
    z = Xc[:, 2]
    vis = z > 0.1
    zs = np.where(vis, z, 1.0)
    u = float(cam.fx) * Xc[:, 0] / zs + float(cam.cx)
    v = float(cam.fy) * Xc[:, 1] / zs + float(cam.cy)
    uv = np.stack([u, v], axis=-1)
    if noise_px > 0:
        uv = uv + rng.normal(0.0, noise_px, uv.shape)
    if outlier_frac > 0:
        out = rng.random(len(uv)) < outlier_frac
        uv[out] = rng.random((out.sum(), 2)) * np.array([width, height])
    vis &= (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    return uv.astype(np.float32), vis


def render_dots(uv: np.ndarray, visible: np.ndarray, width: int = 640,
                height: int = 480, radius: int = 2,
                bg: float = 0.2, fg: float = 0.9) -> np.ndarray:
    """Render visible points as bright squares — frames whose FAST corners
    sit exactly at the projected landmarks (full-pipeline ground truth)."""
    img = np.full((height, width), bg, np.float32)
    r = radius
    for (x, y), v in zip(np.rint(uv).astype(int), visible):
        if not v:
            continue
        if r <= x < width - r and r <= y < height - r:
            img[y - r : y + r + 1, x - r : x + r + 1] = fg
    return img


def normalized(cam: PinholeCamera, uv: np.ndarray) -> np.ndarray:
    return np.asarray(cam.normalize(jnp.asarray(uv)))


def landmark_patches(rng: np.random.Generator, n: int, size: int = 9) -> np.ndarray:
    """(n, size, size) unique high-contrast texture sprites, one per landmark,
    so BRIEF descriptors are distinctive (identical dots would make every
    descriptor match every other)."""
    return (rng.random((n, size, size)) > 0.5).astype(np.float32) * 0.7 + 0.15


def render_patches(uv: np.ndarray, visible: np.ndarray, patches: np.ndarray,
                   width: int = 640, height: int = 480,
                   bg: float = 0.45) -> np.ndarray:
    """Render landmark sprites at their projections (no perspective warp —
    approximately view-invariant for small patches; good enough for VO
    ground-truth sequences)."""
    img = np.full((height, width), bg, np.float32)
    p = patches.shape[-1]
    r = p // 2
    for i, ((x, y), v) in enumerate(zip(np.rint(uv).astype(int), visible)):
        if not v:
            continue
        if r <= x < width - r and r <= y < height - r:
            img[y - r : y + r + 1, x - r : x + r + 1] = patches[i]
    return img


_RAY_CACHE: dict = {}


class TexturedRoom:
    """A procedurally textured axis-aligned box room, rendered by ray
    casting — perspective-correct and view-consistent (unlike sprite
    pasting, where detected corners carry an image-space offset that is
    inconsistent across baselines and biases VO).

    Each face carries a bilinearly-sampled random grid texture: dense
    FAST-corner-rich structure whose corners are true 3D points.
    ``octaves > 1`` overlays finer-scale texture (detail at several spatial
    frequencies, like real indoor scenes).
    """

    def __init__(self, rng: np.random.Generator, half_size=(6.0, 4.0, 6.0),
                 tex_res: int = 64, octaves: int = 1, clutter: int = 0):
        self.half = np.asarray(half_size, np.float64)
        # 6 faces x (tex_res, tex_res) random grid textures per octave.
        res = tex_res
        base = rng.random((6, res + 1, res + 1))
        tex = 0.15 + 0.7 * (base > 0.5).astype(np.float64)
        for o in range(1, octaves):
            # Each octave DOUBLES the resolution (the previous code scaled
            # by 2**o of the *current* res per octave, which compounds to
            # res * 2**(o*(o+1)/2) — a 12 GB texture at octaves=4).
            r2 = res * 2
            fine = rng.random((6, r2 + 1, r2 + 1)) > 0.5
            # Downweight finer octaves; upsample by indexing at render time
            # is avoided by folding into one texture at the finest res.
            up = np.repeat(np.repeat(tex, 2, axis=1), 2, axis=2)
            up = up[:, : r2 + 1, : r2 + 1]
            tex = up + (fine.astype(np.float64) - 0.5) * (0.5 / (2 ** o))
            res = r2
        self.tex = np.clip(tex, 0.02, 0.98)
        self.res = res
        # Interior clutter: textured axis-aligned boxes at varied depths.
        # A bare box room is planar at close range (approaching a wall the
        # whole view has ~zero parallax structure — the degenerate case
        # real desk/indoor scenes never present); clutter restores the
        # depth variety of real scenes and exercises occlusion.
        self.boxes: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for _ in range(clutter):
            size = rng.uniform(0.25, 0.9, 3)
            margin = self.half - size - 0.3
            center = rng.uniform(-1.0, 1.0, 3) * np.maximum(margin, 0.1)
            # Bias clutter toward the floor half (furniture-like).
            center[1] = -abs(center[1]) * 0.7 + size[1]
            btex = 0.1 + 0.8 * (rng.random((6, 33, 33)) > 0.5)
            fine = rng.random((6, 65, 65)) > 0.5
            up = np.repeat(np.repeat(btex, 2, axis=1), 2, axis=2)[:, :65, :65]
            btex = np.clip(up + (fine - 0.5) * 0.3, 0.02, 0.98)
            self.boxes.append((center, size, btex))

    def render(self, cam: PinholeCamera, R: np.ndarray, t: np.ndarray,
               width: int, height: int,
               dist: dict | None = None) -> np.ndarray:
        """Render the room for pose (R, t).  With ``dist`` (radtan dict) the
        camera is a DISTORTED pinhole: each pixel's ray is cast through the
        inverse distortion, producing an exactly-distorted image with no
        resampling pass."""
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        # The (possibly distortion-inverted) ray grid is identical for every
        # frame of a sequence — cache it (the iterative radtan inverse over
        # H*W pixels dominated sequence rendering time).
        key = (fx, fy, cx, cy, width, height,
               tuple(sorted(dist.items())) if dist else None)
        d_cam = _RAY_CACHE.get(key)
        if d_cam is None:
            us, vs = np.meshgrid(np.arange(width), np.arange(height))
            xn = (us - cx) / fx
            yn = (vs - cy) / fy
            if dist is not None:
                from tinyslam.data.undistort import radtan_undistort_points

                xn, yn = radtan_undistort_points(xn, yn, **dist)
            d_cam = np.stack([xn, yn, np.ones_like(xn, np.float64)], -1)
            if len(_RAY_CACHE) < 8:
                _RAY_CACHE[key] = d_cam
        Rm = np.asarray(R, np.float64)
        C = -Rm.T @ np.asarray(t, np.float64)
        d = d_cam @ Rm  # (H, W, 3) world-frame ray dirs (R^T applied rowwise)

        best_t = np.full((height, width), np.inf)
        out = np.full((height, width), 0.4)
        for axis in range(3):
            for sign in (-1.0, 1.0):
                bound = sign * self.half[axis]
                da = d[..., axis]
                with np.errstate(divide="ignore", invalid="ignore"):
                    th = (bound - C[axis]) / da
                P = C[None, None, :] + th[..., None] * d
                a1, a2 = [i for i in range(3) if i != axis]
                ok = (
                    (th > 1e-6)
                    & np.isfinite(th)
                    & (np.abs(P[..., a1]) <= self.half[a1] + 1e-9)
                    & (np.abs(P[..., a2]) <= self.half[a2] + 1e-9)
                    & (th < best_t)
                )
                # Face texture coords in [0, 1).
                ua = (P[..., a1] / self.half[a1] + 1) * 0.5
                va = (P[..., a2] / self.half[a2] + 1) * 0.5
                face = axis * 2 + (sign > 0)
                val = self._sample(int(face), ua, va)
                out = np.where(ok, val, out)
                best_t = np.where(ok, th, best_t)
        out, best_t = self._hit_boxes(C, d, out, best_t)
        return out.astype(np.float32)

    def _hit_boxes(self, C, d, out, best_t):
        """Nearest-hit tests against the interior clutter boxes."""
        for center, size, btex in self.boxes:
            for axis in range(3):
                for sign in (-1.0, 1.0):
                    bound = center[axis] + sign * size[axis]
                    da = d[..., axis]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        th = (bound - C[axis]) / da
                    P = C[None, None, :] + th[..., None] * d
                    a1, a2 = [i for i in range(3) if i != axis]
                    ok = (
                        (th > 1e-6)
                        & np.isfinite(th)
                        & (np.abs(P[..., a1] - center[a1]) <= size[a1] + 1e-9)
                        & (np.abs(P[..., a2] - center[a2]) <= size[a2] + 1e-9)
                        & (th < best_t)
                    )
                    if not ok.any():
                        continue
                    ua = ((P[..., a1] - center[a1]) / size[a1] + 1) * 0.5
                    va = ((P[..., a2] - center[a2]) / size[a2] + 1) * 0.5
                    face = axis * 2 + (sign > 0)
                    x = np.clip(ua, 0, 1) * 64
                    y = np.clip(va, 0, 1) * 64
                    x0 = np.clip(x.astype(int), 0, 63)
                    y0 = np.clip(y.astype(int), 0, 63)
                    fx, fy = x - x0, y - y0
                    T = btex[int(face)]
                    val = (T[y0, x0] * (1 - fx) * (1 - fy)
                           + T[y0, x0 + 1] * fx * (1 - fy)
                           + T[y0 + 1, x0] * (1 - fx) * fy
                           + T[y0 + 1, x0 + 1] * fx * fy)
                    out = np.where(ok, val, out)
                    best_t = np.where(ok, th, best_t)
        return out, best_t

    def raycast(self, cam: PinholeCamera, R: np.ndarray, t: np.ndarray,
                uv: np.ndarray) -> np.ndarray:
        """Ground-truth 3D points (world) hit by rays through pixels uv (N, 2)."""
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        d_cam = np.stack(
            [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1
        )
        Rm = np.asarray(R, np.float64)
        C = -Rm.T @ np.asarray(t, np.float64)
        d = d_cam @ Rm
        best_t = np.full(len(uv), np.inf)
        P_out = np.zeros((len(uv), 3))
        surfaces = [(np.zeros(3), self.half)] + [
            (c, s) for c, s, _ in self.boxes]
        for center, half in surfaces:
            for axis in range(3):
                for sign in (-1.0, 1.0):
                    bound = center[axis] + sign * half[axis]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        th = (bound - C[axis]) / d[:, axis]
                    P = C[None] + th[:, None] * d
                    a1, a2 = [i for i in range(3) if i != axis]
                    ok = (
                        (th > 1e-6) & np.isfinite(th)
                        & (np.abs(P[:, a1] - center[a1]) <= half[a1] + 1e-9)
                        & (np.abs(P[:, a2] - center[a2]) <= half[a2] + 1e-9)
                        & (th < best_t)
                    )
                    P_out = np.where(ok[:, None], P, P_out)
                    best_t = np.where(ok, th, best_t)
        return P_out

    def _sample(self, face: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        res = self.res
        x = np.clip(u, 0, 1) * (res - 1)
        y = np.clip(v, 0, 1) * (res - 1)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        ax = x - x0
        ay = y - y0
        t = self.tex[face]
        return (
            t[y0, x0] * (1 - ax) * (1 - ay)
            + t[y0, x0 + 1] * ax * (1 - ay)
            + t[y0 + 1, x0] * (1 - ax) * ay
            + t[y0 + 1, x0 + 1] * ax * ay
        )


def _smooth_walk(rng: np.random.Generator, n: int, dims: int,
                 sigma: float, window: int) -> np.ndarray:
    """(n, dims) zero-mean smooth random walk: white noise -> cumsum -> box
    smoothing -> de-trended; the low-frequency wander of handheld motion."""
    steps = rng.normal(0.0, sigma, (n + window, dims))
    walk = np.cumsum(steps, axis=0)
    kernel = np.ones(window) / window
    sm = np.stack([np.convolve(walk[:, d], kernel, mode="same")
                   for d in range(dims)], -1)[:n]
    return sm - sm.mean(axis=0)


def handheld_trajectory(rng: np.random.Generator, num_frames: int,
                        radius: float = 2.0, step: float = 0.012,
                        target=(0.0, 0.0, 2.0), jitter_pos: float = 0.004,
                        jitter_tgt: float = 0.01, height_amp: float = 0.15,
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
    """A TUM-fr1-desk-like handheld sweep: a slow arc around the scene with
    smoothed 6-DoF jitter (position tremor + independent look-target wander,
    i.e. coupled rotation noise) and a slow vertical bob."""
    tgt0 = np.asarray(target, np.float64)
    jp = _smooth_walk(rng, num_frames, 3, jitter_pos, 12)
    jt = _smooth_walk(rng, num_frames, 3, jitter_tgt, 18)
    poses = []
    for i in range(num_frames):
        a = -0.45 + i * step
        h = 0.4 + height_amp * np.sin(i * 0.05)
        pos = np.array([radius * np.sin(a), h, -radius * np.cos(a)]) + tgt0
        poses.append(look_at(pos + jp[i], tgt0 + jt[i]))
    return poses


def mav_trajectory(rng: np.random.Generator, num_frames: int,
                   radius: float = 3.0, step: float = 0.02,
                   target=(0.0, 0.0, 1.0)) -> list[tuple[np.ndarray, np.ndarray]]:
    """A EuRoC-MH-like aggressive sweep: faster arc, larger excursions, yaw
    ahead of the track (MAVs look into the turn), strong height changes."""
    tgt0 = np.asarray(target, np.float64)
    jp = _smooth_walk(rng, num_frames, 3, 0.01, 20)
    jt = _smooth_walk(rng, num_frames, 3, 0.02, 25)
    poses = []
    for i in range(num_frames):
        a = -0.6 + i * step
        h = 0.2 + 0.8 * np.sin(i * 0.025)
        pos = np.array([radius * np.sin(a), h, -radius * np.cos(a)]) + tgt0
        look = tgt0 + np.array([1.2 * np.sin(a + 0.3), 0.3 * np.sin(i * 0.04),
                                -1.2 * np.cos(a + 0.3)]) * 0.3
        poses.append(look_at(pos + jp[i], look + jt[i]))
    return poses


def apply_photometrics(img: np.ndarray, rng: np.random.Generator,
                       exposure: float = 1.0, vignette: float = 0.25,
                       noise_std: float = 0.006,
                       quantize: bool = True) -> np.ndarray:
    """Real-camera image statistics on a clean render: vignetting (cos^4
    falloff), per-frame exposure gain, sensor noise, 8-bit quantization.
    Returns uint8 when ``quantize`` (what a real dataset PNG holds)."""
    h, w = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2) / 2.0
    vig = 1.0 - vignette * r2
    out = img * vig * exposure
    out = out + rng.normal(0.0, noise_std, out.shape)
    out = np.clip(out, 0.0, 1.0)
    if quantize:
        return np.rint(out * 255.0).astype(np.uint8)
    return out.astype(np.float32)


def exposure_track(rng: np.random.Generator, n: int,
                   amp: float = 0.15) -> np.ndarray:
    """Smooth per-frame exposure gains around 1.0 (auto-exposure hunting)."""
    return 1.0 + _smooth_walk(rng, n, 1, amp / 8, 30)[:, 0].clip(-amp, amp)


def render_sequence(rng: np.random.Generator, poses, cam: PinholeCamera,
                    width: int, height: int, room: "TexturedRoom",
                    dist: dict | None = None,
                    photometric: bool = True) -> list[np.ndarray]:
    """Render poses through a (possibly distorted) camera with photometric
    effects — uint8 frames statistically shaped like a real dataset's."""
    gains = exposure_track(rng, len(poses)) if photometric else None
    frames = []
    for i, (R, t) in enumerate(poses):
        img = room.render(cam, R, t, width, height, dist=dist)
        if photometric:
            img = apply_photometrics(img, rng, exposure=float(gains[i]))
        frames.append(img)
    return frames


def write_tum_sequence(root, images, poses, fps: float = 30.0) -> None:
    """Write frames + ground truth in the real TUM RGB-D layout (rgb.txt,
    rgb/*.png, groundtruth.txt) so the actual TumSequence loader, native PNG
    decode and undistortion path are exercised end to end."""
    from pathlib import Path

    from tinyslam.data.png import write_png

    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    rgb_lines, gt_lines = [], []
    for i, (img, (R, t)) in enumerate(zip(images, poses)):
        ts = i / fps
        name = f"rgb/{ts:.6f}.png"
        write_png(root / name, img)
        rgb_lines.append(f"{ts:.6f} {name}")
        C = -np.asarray(R).T @ np.asarray(t)
        q = rotation_to_quat(np.asarray(R).T)     # cam->world, TUM convention
        gt_lines.append(
            f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    (root / "rgb.txt").write_text("# ts path\n" + "\n".join(rgb_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# ts tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")


def write_euroc_sequence(root, images, poses, fps: float = 20.0) -> None:
    """Write frames + GT in the real EuRoC ASL layout (mav0/cam0/data.csv,
    data/*.png, state_groundtruth_estimate0/data.csv)."""
    from pathlib import Path

    from tinyslam.data.png import write_png

    root = Path(root)
    cam_dir = root / "mav0" / "cam0" / "data"
    cam_dir.mkdir(parents=True, exist_ok=True)
    gt_dir = root / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True, exist_ok=True)
    cam_lines, gt_lines = [], []
    for i, (img, (R, t)) in enumerate(zip(images, poses)):
        ts_ns = int(1.4e18) + int(i * 1e9 / fps)
        write_png(cam_dir / f"{ts_ns}.png", img)
        cam_lines.append(f"{ts_ns},{ts_ns}.png")
        C = -np.asarray(R).T @ np.asarray(t)
        q = rotation_to_quat(np.asarray(R).T)     # body==cam -> world
        gt_lines.append(
            f"{ts_ns},{C[0]:.6f},{C[1]:.6f},{C[2]:.6f},"
            f"{q[3]:.6f},{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},"
            "0,0,0,0,0,0,0,0,0")
    (root / "mav0" / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n" + "\n".join(cam_lines) + "\n")
    (gt_dir / "data.csv").write_text(
        "#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,...\n"
        + "\n".join(gt_lines) + "\n")


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (qx, qy, qz, qw); inverse of
    data/tum.py quat_to_rotation."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def vo_sequence(rng: np.random.Generator, num_frames: int = 60,
                num_points: int = 400, width: int = 320, height: int = 240,
                radius: float = 2.0, step: float = 0.03):
    """A full synthetic VO sequence: a camera orbiting inside a textured
    room at a fixed angular step per frame (motion rate independent of
    sequence length).  Returns (cam, images, gt_poses (world->cam), room)."""
    cam = PinholeCamera.create(fx=260.0, fy=260.0,
                               cx=width / 2 - 0.5, cy=height / 2 - 0.5)
    room = TexturedRoom(rng)
    poses = orbit_trajectory(num_frames, radius=radius, step=step,
                             start=-0.35, target=(0.0, 0.0, 2.0))
    images = [room.render(cam, R, t, width, height) for R, t in poses]
    return cam, images, poses, room
