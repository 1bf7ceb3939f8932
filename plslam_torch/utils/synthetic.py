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


def make_synthetic_ba_map(cfg, n_kf: int = 72, n_pts: int = 300,
                          obs_per_kf: int = 96, noise: float = 0.5,
                          pose_pert: float = 0.01, pt_pert: float = 0.02,
                          seed: int = 0, device="cuda"):
    """A SlamMap populated directly (no tracking pass) for exercising the
    engine's bundle-adjustment paths at global-BA scale: cameras on an arc
    observing a point cloud, pixel-noise observations wired through
    ``kf_pt_idx`` / ``pt_obs`` exactly as tracking would, keyframe feature
    snapshots carrying the observed (u, v, u_right). Initial poses and
    points are perturbed from ground truth; keyframe 0 is exact (the gauge
    anchor). The numpy draws are those of the JAX package's function, in
    the same order, so one seed gives both packages the same map.

    Returns (map, gt_poses, gt_pts), the ground truth as the target of
    assertions.
    """
    import torch

    from ..geometry import se3
    from ..models.frame import FrameData
    from ..models.map import HostFrame, SlamMap

    rng = np.random.default_rng(seed)
    m = SlamMap(cfg, device=device)
    cam = cfg.camera
    n_cap = cfg.orb.max_keypoints
    nl_cap = cfg.lines.max_lines
    obs_per_kf = min(obs_per_kf, n_cap)

    gt_poses = []
    for i in range(n_kf):
        ang = 0.5 * np.sin(2 * np.pi * i / n_kf)
        Rwc = se3.so3_exp(torch.tensor([0.0, ang, 0.0], dtype=torch.float32)).numpy()
        c = np.array([1.2 * np.sin(ang), 0.02 * i % 0.6, -0.4 * np.cos(ang)], np.float32)
        R = Rwc.T.astype(np.float32)
        gt_poses.append((R, (-R @ c).astype(np.float32)))
    gt_pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (n_pts, 3)).astype(np.float32)

    # register the landmarks (perturbed) once
    pids = []
    for p in range(n_pts):
        pw = gt_pts[p] + rng.normal(0, pt_pert, 3).astype(np.float32)
        pids.append(m.add_point(pw, np.zeros(32, np.uint8), np.array([0, 0, 1], np.float32),
                                0.1, 100.0, 0))
    pids = np.array(pids, np.int32)

    z = np.zeros
    for i, (R, t) in enumerate(gt_poses):
        if i == 0:
            Rp, tp = R, t
        else:
            xi = rng.standard_normal(6).astype(np.float32) * pose_pert
            Rj, tj = se3.left_update(torch.from_numpy(xi), torch.from_numpy(R),
                                     torch.from_numpy(t))
            Rp, tp = Rj.numpy(), tj.numpy()
        sel = rng.choice(n_pts, size=obs_per_kf, replace=False)
        pc = gt_pts[sel] @ R.T + t
        ok = pc[:, 2] > 0.3
        u = cam.fx * pc[:, 0] / np.maximum(pc[:, 2], 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(pc[:, 2], 1e-6) + cam.cy
        ok &= (u > 5) & (u < cam.width - 5) & (v > 5) & (v < cam.height - 5)
        u = u + rng.normal(0, noise, obs_per_kf)
        v = v + rng.normal(0, noise, obs_per_kf)
        ur = u - cam.bf / np.maximum(pc[:, 2], 1e-6) + rng.normal(0, noise, obs_per_kf)
        kp_xy = z((n_cap, 2), np.float32)
        kp_ur = np.full(n_cap, -1.0, np.float32)
        kp_valid = z(n_cap, bool)
        idx = np.nonzero(ok)[0]
        k = len(idx)
        kp_xy[:k, 0], kp_xy[:k, 1] = u[idx], v[idx]
        kp_ur[:k] = ur[idx]
        kp_valid[:k] = True
        fd = FrameData(
            kp_xy=kp_xy, kp_xy_un=kp_xy, kp_resp=z(n_cap, np.float32),
            kp_octave=z(n_cap, np.int32), kp_angle=z(n_cap, np.float32),
            kp_desc=z((n_cap, 32), np.uint8), kp_depth=z(n_cap, np.float32), kp_ur=kp_ur,
            kp_valid=kp_valid, ln_ep=z((nl_cap, 2, 2), np.float32),
            ln_ep_un=z((nl_cap, 2, 2), np.float32), ln_angle=z(nl_cap, np.float32),
            ln_length=z(nl_cap, np.float32), ln_coeff=z((nl_cap, 3), np.float32),
            ln_desc=z((nl_cap, 72), np.uint8), ln_depth=z((nl_cap, 2), np.float32),
            ln_valid=z(nl_cap, bool),
        )
        kf = m.add_keyframe(HostFrame(fd), Rp, tp, i, i / 30.0)
        for feat, j in enumerate(idx):
            m.add_point_obs(int(pids[sel[j]]), kf, feat)
    return m, gt_poses, gt_pts
