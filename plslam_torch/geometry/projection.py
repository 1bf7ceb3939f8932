"""Pinhole camera projection / unprojection and radial-tangential distortion.

Reproduces the camera model of the reference (OpenCV intrinsics + k1 k2 p1 p2
[k3] distortion, ``Frame.cc:737-845`` UndistortKeyPoints and
``Tracking.cc:53-87`` settings parse) as batched torch functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Static camera parameters (python floats — hashable)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 40.0        # baseline * fx (virtual stereo for RGB-D)
    width: int = 640
    height: int = 480

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            np.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coords (..., 2). No distortion
    (the reference projects into undistorted coordinates)."""
    z = pc[..., 2:3]
    inv_z = 1.0 / torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    xy = pc[..., :2] * inv_z
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Iteratively undistort pixel coordinates (cv::undistortPoints semantics).

    Fixed-point iteration x_{k+1} = (x_d - tangential(x_k)) / radial(x_k);
    8 iterations match OpenCV's default termination for typical TUM lenses.
    """
    if not cam.has_distortion:
        return uv
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    u = cam.fx * x + cam.cx
    v = cam.fy * y + cam.cy
    return torch.stack([u, v], dim=-1)


def undistorted_bounds(cam: Camera) -> tuple[float, float, float, float]:
    """Image bounds after undistortion (reference Frame::ComputeImageBounds,
    Frame.cc:847-884). Returns (min_x, max_x, min_y, max_y) as python
    floats."""
    if not cam.has_distortion:
        return 0.0, float(cam.width), 0.0, float(cam.height)
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]],
        dtype=torch.float32,
    )
    und = undistort_points(cam, corners).numpy()
    return (
        float(min(und[0, 0], und[2, 0])),
        float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])),
        float(max(und[2, 1], und[3, 1])),
    )
