"""Synthetic RGB-D room renderer with exact ground truth.

Renders a textured axis-aligned box room (walls/floor/ceiling carry smooth
procedural texture plus dark grid lines => real 3D line structure) by ray
casting. Produces (gray, depth) pairs with perfect ground-truth poses —
the end-to-end test bed standing in for TUM sequences (no dataset in this
environment), exercising exactly the pipeline the reference runs on fr1/fr3.
Convention matches the engine: x_cam = R @ x_world + t, depth = z_cam.
"""

from __future__ import annotations

import numpy as np

from ..geometry.projection import Camera

_EPS = 1e-8


class RoomScene:
    """Box interior: x in [-2,2], y in [-1.5,1.5], z in [-1,3.5] (y down).

    TUM-fr1-like depth range (~0.8-4 m) so ThDepth-based close-point logic
    behaves as on the real sequences.
    """

    def __init__(self, seed: int = 0, tex_size: int = 512):
        rng = np.random.default_rng(seed)
        self.planes = [
            # (axis, value)
            (2, 3.5), (2, -1.0), (0, -2.0), (0, 2.0), (1, -1.5), (1, 1.5),
        ]
        self.bounds = np.array([[-2.0, 2.0], [-1.5, 1.5], [-1.0, 3.5]])
        self.tex = []
        for k in range(6):
            # multi-octave noise -> locally unique descriptors (a uniform
            # grid on smooth noise aliases: every crossing looks identical
            # and window matching locks onto wrong corners)
            t = _upsample(rng.uniform(60, 160, (tex_size // 16, tex_size // 16)), tex_size)
            t += _upsample(rng.uniform(-30, 30, (tex_size // 4, tex_size // 4)), tex_size)
            t += rng.uniform(-12, 12, (tex_size, tex_size))
            # random high-contrast rectangles ("posters"/"furniture")
            for _ in range(24):
                x0, y0 = rng.integers(0, tex_size - 60, 2)
                w0, h0 = rng.integers(16, 80, 2)
                t[y0 : y0 + h0, x0 : x0 + w0] += rng.uniform(-70, 70)
            # grid lines with per-line varying intensity (3D line structure)
            metres = 8.0
            px_per_m = tex_size / metres
            step = int(0.75 * px_per_m)
            width = max(int(0.025 * px_per_m), 2)
            for i in range(0, tex_size, step):
                t[i : i + width, :] = rng.uniform(180, 250)
                t[:, i : i + width] = rng.uniform(0, 60)
            self.tex.append(np.clip(t, 0, 255).astype(np.float32))
        self.tex_size = tex_size

    def render(self, cam: Camera, R: np.ndarray, t: np.ndarray):
        """Render (gray, depth) for pose x_cam = R x_world + t."""
        w, h = cam.width, cam.height
        u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                           np.arange(h, dtype=np.float32))
        d_cam = np.stack(
            [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], -1
        )  # (h, w, 3), z component 1 -> ray param == camera z == depth
        Rw = R.T
        o = -Rw @ t                       # camera center in world
        dw = d_cam @ R                    # world-frame ray directions

        depth = np.full((h, w), np.inf, np.float32)
        gray = np.full((h, w), 40.0, np.float32)
        for k, (axis, value) in enumerate(self.planes):
            denom = dw[..., axis]
            s = (value - o[axis]) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
            p = o[None, None, :] + s[..., None] * dw  # (h, w, 3)
            ax_u, ax_v = [a for a in (0, 1, 2) if a != axis]
            inb = (
                (s > 0.05)
                & (np.abs(denom) > 1e-9)
                & (p[..., ax_u] >= self.bounds[ax_u, 0] - 1e-3)
                & (p[..., ax_u] <= self.bounds[ax_u, 1] + 1e-3)
                & (p[..., ax_v] >= self.bounds[ax_v, 0] - 1e-3)
                & (p[..., ax_v] <= self.bounds[ax_v, 1] + 1e-3)
            )
            closer = inb & (s < depth)
            # texture lookup (planes span up to 8 m, texture covers 8 m)
            tu = (p[..., ax_u] + 4.0) / 8.0 * (self.tex_size - 1)
            tv = (p[..., ax_v] + 4.0) / 8.0 * (self.tex_size - 1)
            val = _bilinear_np(self.tex[k], tu, tv)
            depth = np.where(closer, s, depth)
            gray = np.where(closer, val, gray)
        depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
        return gray.astype(np.float32), depth


def _upsample(small: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsample without cv2 dependency."""
    sh, sw = small.shape
    yy = np.linspace(0, sh - 1, size)
    xx = np.linspace(0, sw - 1, size)
    gx, gy = np.meshgrid(xx, yy)
    return _bilinear_np(small, gx, gy)


def _bilinear_np(img, x, y):
    h, w = img.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    fx = x - x0
    fy = y - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    ).astype(np.float32)


def _so3_exp_f32(w: np.ndarray) -> np.ndarray:
    """Rodrigues in float32 numpy, the same arithmetic as ``se3.so3_exp``
    (so trajectories match the JAX package's to ~1e-7 without a device)."""
    w = np.asarray(w, np.float32)
    theta2 = np.float32(np.dot(w, w))
    theta = np.sqrt(theta2 + np.float32(_EPS * _EPS))
    if theta2 > _EPS:
        a = np.sin(theta) / theta
        b = (np.float32(1.0) - np.cos(theta)) / theta2
    else:
        a = np.float32(1.0) - theta2 / np.float32(6.0)
        b = np.float32(0.5) - theta2 / np.float32(24.0)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]],
                 np.float32)
    return (np.eye(3, dtype=np.float32) + a * W + b * (W @ W)).astype(np.float32)


def smooth_trajectory(n_frames: int, amplitude: float = 0.6):
    """Ground-truth world-to-camera poses along a smooth exploring path.

    Returns a list of (R, t) with x_cam = R x_world + t.
    """
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        # camera center path + gentle look-around (stays inside the room)
        c = np.array(
            [amplitude * np.sin(2 * np.pi * a),
             0.25 * np.sin(4 * np.pi * a),
             0.7 * np.sin(2 * np.pi * a + 0.5)],
            np.float32,
        )
        yaw = 0.25 * np.sin(2 * np.pi * a)
        pitch = 0.1 * np.sin(4 * np.pi * a + 1.0)
        Rwc = _so3_exp_f32(np.array([pitch, yaw, 0.0], np.float32))
        R = Rwc.T
        t = -R @ c
        poses.append((R.astype(np.float32), t.astype(np.float32)))
    return poses
