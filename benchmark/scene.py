"""The benchmark's scene: a textured box room with an exact camera path.

A frozen copy of the room of ``plslam_torch.utils.synthetic.RoomScene``
(the same textures from the same seed, drawn with numpy in the same order)
with the renderer rewritten in torch, so that a whole sequence renders on
the card in a few batched calls. The camera path is the package's
``smooth_trajectory`` made periodic: frame i sits at phase i / period, so a
replay that wraps at the period moves on without a jump.

Convention: x_cam = R x_world + t, depth = z_cam.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (axis, value) of the six walls; x in [-2, 2], y in [-1.5, 1.5], z in [-1, 3.5]
PLANES = ((2, 3.5), (2, -1.0), (0, -2.0), (0, 2.0), (1, -1.5), (1, 1.5))
BOUNDS = ((-2.0, 2.0), (-1.5, 1.5), (-1.0, 3.5))


def _bilinear_np(img, x, y):
    h, w = img.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy
            ).astype(np.float32)


def _upsample(small: np.ndarray, size: int) -> np.ndarray:
    sh, sw = small.shape
    gx, gy = np.meshgrid(np.linspace(0, sw - 1, size), np.linspace(0, sh - 1, size))
    return _bilinear_np(small, gx, gy)


def room_textures(seed: int, tex_size: int = 512) -> np.ndarray:
    """The six wall textures (6, T, T) float32 of ``RoomScene(seed)``:
    multi-octave noise, random posters and a grid of dark and bright lines."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        t = _upsample(rng.uniform(60, 160, (tex_size // 16, tex_size // 16)), tex_size)
        t += _upsample(rng.uniform(-30, 30, (tex_size // 4, tex_size // 4)), tex_size)
        t += rng.uniform(-12, 12, (tex_size, tex_size))
        for _ in range(24):
            x0, y0 = rng.integers(0, tex_size - 60, 2)
            w0, h0 = rng.integers(16, 80, 2)
            t[y0:y0 + h0, x0:x0 + w0] += rng.uniform(-70, 70)
        px_per_m = tex_size / 8.0
        step = int(0.75 * px_per_m)
        width = max(int(0.025 * px_per_m), 2)
        for i in range(0, tex_size, step):
            t[i:i + width, :] = rng.uniform(180, 250)
            t[:, i:i + width] = rng.uniform(0, 60)
        out.append(np.clip(t, 0, 255).astype(np.float32))
    return np.stack(out)


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues, float64, for rows of rotation vectors (n, 3)."""
    theta = np.linalg.norm(w, axis=-1)[:, None, None]
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[:, 0, 1], W[:, 0, 2], W[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    W -= W.transpose(0, 2, 1)
    safe = np.where(theta > 1e-12, theta, 1.0)
    a = np.where(theta > 1e-12, np.sin(safe) / safe, 1.0)
    b = np.where(theta > 1e-12, (1.0 - np.cos(safe)) / safe**2, 0.5)
    return np.eye(3) + a * W + b * (W @ W)


def path_poses(frames, period: int, amplitude: float = 0.6, yaw: float = 0.25,
               pitch: float = 0.1):
    """World-to-camera (R (n, 3, 3), t (n, 3)) in float64 of the path at
    frame indices ``frames``: the camera centre and the look-around of
    ``smooth_trajectory`` (whose amplitudes are the defaults, in metres and
    radians), at phase frame / period."""
    a = np.asarray(frames, np.float64) / period
    c = np.stack([amplitude * np.sin(2 * np.pi * a), 0.25 * np.sin(4 * np.pi * a),
                  0.7 * np.sin(2 * np.pi * a + 0.5)], -1)
    yaw = yaw * np.sin(2 * np.pi * a)
    pitch = pitch * np.sin(4 * np.pi * a + 1.0)
    Rwc = _so3_exp(np.stack([pitch, yaw, np.zeros_like(a)], -1))
    R = Rwc.transpose(0, 2, 1)
    t = -np.einsum("nij,nj->ni", R, c)
    return R, t


def path_speed(period: int, fps: float, **path) -> tuple[float, float]:
    """Mean speed (m/s) and mean rotation rate (degrees/s) of the path."""
    R, t = path_poses(np.arange(period + 1), period, **path)
    c = -np.einsum("nji,nj->ni", R, t)
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    rel = R[1:] @ R[:-1].transpose(0, 2, 1)
    ang = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
    return float(step.mean() * fps), float(np.degrees(ang).mean() * fps)


class Room:
    """The room's textures on ``device``, rendered through a pinhole camera
    (fx, fy, cx, cy, width, height) in batches of poses."""

    def __init__(self, seed: int, device, tex_size: int = 512):
        self.tex = torch.as_tensor(room_textures(seed, tex_size), device=device)
        self.tex_size = tex_size
        self.device = device

    def render(self, cam, R: torch.Tensor, t: torch.Tensor):
        """(gray (n, h, w) float32, depth (n, h, w) float32 metres, 0 where no
        wall) of the poses R (n, 3, 3), t (n, 3) (float32, on the device)."""
        dev = self.device
        h, w = cam.height, cam.width
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                              torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        d_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                             torch.ones_like(u)], -1)                  # (h, w, 3)
        o = -torch.einsum("nji,nj->ni", R, t)                           # centres (n, 3)
        dw = torch.einsum("hwj,njk->nhwk", d_cam, R)                     # d_cam @ R
        n = R.shape[0]
        depth = torch.full((n, h, w), math.inf, dtype=torch.float32, device=dev)
        gray = torch.full((n, h, w), 40.0, dtype=torch.float32, device=dev)
        last = self.tex_size - 1
        for k, (axis, value) in enumerate(PLANES):
            denom = dw[..., axis]
            ok_d = denom.abs() > 1e-9
            s = (value - o[:, axis, None, None]) / torch.where(ok_d, denom,
                                                               torch.full_like(denom, 1e-9))
            p = o[:, None, None, :] + s[..., None] * dw
            au, av = (a for a in (0, 1, 2) if a != axis)
            inb = ((s > 0.05) & ok_d
                   & (p[..., au] >= BOUNDS[au][0] - 1e-3) & (p[..., au] <= BOUNDS[au][1] + 1e-3)
                   & (p[..., av] >= BOUNDS[av][0] - 1e-3) & (p[..., av] <= BOUNDS[av][1] + 1e-3))
            closer = inb & (s < depth)
            tu = ((p[..., au] + 4.0) / 8.0 * last).clamp(0, last - 0.001)
            tv = ((p[..., av] + 4.0) / 8.0 * last).clamp(0, last - 0.001)
            x0 = tu.to(torch.int64)
            y0 = tv.to(torch.int64)
            fx = tu - x0
            fy = tv - y0
            tex = self.tex[k].reshape(-1)
            at = y0 * self.tex_size + x0
            val = (tex[at] * (1 - fx) * (1 - fy) + tex[at + 1] * fx * (1 - fy)
                   + tex[at + self.tex_size] * (1 - fx) * fy
                   + tex[at + self.tex_size + 1] * fx * fy)
            depth = torch.where(closer, s, depth)
            gray = torch.where(closer, val, gray)
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
        return gray, depth


def to_wire(gray: torch.Tensor, depth: torch.Tensor, depth_map_factor: float):
    """A camera's wire format, on the device: uint8 gray and depth in
    ``depth_map_factor`` units (int32 holding uint16 values), truncated as
    numpy's ``astype`` truncates."""
    g = gray.clamp(0, 255).to(torch.uint8)
    d = (depth * depth_map_factor).clamp(0, 65535).to(torch.int32)
    return g, d
