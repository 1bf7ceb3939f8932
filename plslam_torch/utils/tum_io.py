"""TUM RGB-D dataset IO and trajectory writers.

The port of the JAX package's ``utils/tum_io.py``; the files it writes are
byte for byte the ones the JAX package writes from the same poses.
File-format parity with the reference:
- association files (``rgbd_my.cpp:40-58`` LoadImages semantics),
- TUM trajectory format ``ts tx ty tz qx qy qz qw`` per frame
  (``System::SaveTrajectoryTUM``, the reference's src/System.cc:337-396),
- TUM keyframe trajectory (``System.cc:398-441``),
- KITTI format 3x4 row-major pose (``System.cc:443-487``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import se3


@dataclass
class TumAssociation:
    timestamps: np.ndarray          # (N,) float64
    rgb_paths: list[str]
    depth_paths: list[str]
    gt_poses: np.ndarray | None = None   # (N, 7) [tx ty tz qx qy qz qw] if present


def load_association(path: str, root: str | None = None) -> TumAssociation:
    """Parse a TUM association file.

    Supports both forms the reference consumes:
      ``ts_rgb rgb/x.png ts_depth depth/y.png``  (associate.py output)
      ``ts_rgb rgb/x.png ts_depth depth/y.png tx ty tz qx qy qz qw``
      (associate_with_groundtruth.txt used by the Test/ programs).
    """
    root = root or os.path.dirname(os.path.abspath(path))
    ts, rgbs, depths, gts = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if len(tok) < 4:
                continue
            ts.append(float(tok[0]))
            rgbs.append(os.path.join(root, tok[1]))
            depths.append(os.path.join(root, tok[3]))
            if len(tok) >= 11:
                gts.append([float(x) for x in tok[4:11]])
    gt = np.array(gts, np.float64) if len(gts) == len(ts) and gts else None
    return TumAssociation(np.array(ts, np.float64), rgbs, depths, gt)


def load_rgb_depth(rgb_path: str, depth_path: str, depth_factor: float = 5000.0):
    """Read one RGB-D pair -> (gray float32 [H,W] in 0..255, depth float32 m).
    OpenCV is imported here only: nothing else of the port needs it."""
    import cv2

    bgr = cv2.imread(rgb_path, cv2.IMREAD_UNCHANGED)
    if bgr is None:
        raise FileNotFoundError(rgb_path)
    if bgr.ndim == 3:
        gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    else:
        gray = bgr
    d = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(depth_path)
    depth = d.astype(np.float32) / depth_factor
    return gray.astype(np.float32), depth


def write_sequence(root: str, grays, depths, timestamps, cam, depth_factor: float = 5000.0):
    """A TUM-format directory of uint8 gray and uint16 depth frames (depth
    in ``depth_factor`` units): ``rgb/*.png`` as 8-bit RGB with equal
    channels, ``depth/*.png`` as 16-bit gray, ``associate.txt`` and a
    ``settings.yaml`` of ``cam`` in the reference's format, written with
    ``utils.png_io`` (no OpenCV) at zlib level 1, the fastest to write."""
    from .png_io import write_png

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    lines = []
    for gray, depth, ts in zip(grays, depths, timestamps):
        rgb_name, depth_name = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        write_png(os.path.join(root, rgb_name), np.repeat(gray[..., None], 3, -1), level=1)
        write_png(os.path.join(root, depth_name), depth, level=1)
        lines.append(f"{ts:.6f} {rgb_name} {ts:.6f} {depth_name}\n")
    with open(os.path.join(root, "associate.txt"), "w") as f:
        f.writelines(lines)
    keys = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, k1=cam.k1, k2=cam.k2,
                p1=cam.p1, p2=cam.p2, width=cam.width, height=cam.height, fps=30.0,
                bf=cam.bf, RGB=1)
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write("%YAML:1.0\n" + "".join(f"Camera.{k}: {v}\n" for k, v in keys.items())
                + f"ThDepth: 40.0\nDepthMapFactor: {depth_factor}\n")


def save_trajectory_tum(path: str, timestamps, poses_twc):
    """Write TUM-format trajectory. ``poses_twc``: list of (R_wc, t_wc).
    The quaternions are computed on the CPU, all rows in one call."""
    Rs = np.array([np.asarray(R, np.float32) for R, _ in poses_twc], np.float32).reshape(-1, 3, 3)
    quats = se3.rot_to_quat(torch.from_numpy(Rs)).numpy()
    with open(path, "w") as f:
        for ts, q, (_, t) in zip(timestamps, quats, poses_twc):
            t = np.asarray(t)
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_trajectory_kitti(path: str, poses_twc):
    """Write KITTI-format trajectory (3x4 row-major per line)."""
    with open(path, "w") as f:
        for R, t in poses_twc:
            R = np.asarray(R)
            t = np.asarray(t)
            row = np.hstack([R, t.reshape(3, 1)]).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_trajectory_tum(path: str):
    """Read TUM trajectory -> (timestamps (N,), positions (N,3), quats (N,4))."""
    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = [float(x) for x in line.split()]
            if len(tok) >= 8:
                data.append(tok[:8])
    arr = np.array(data, np.float64)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def ate_rmse(ts_est, pos_est, ts_gt, pos_gt, max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after time-association + SE3 alignment
    (the standard TUM evaluate_ate.py protocol: Horn alignment, no scale)."""
    # associate by nearest timestamp
    idx_gt = np.searchsorted(ts_gt, ts_est)
    idx_gt = np.clip(idx_gt, 0, len(ts_gt) - 1)
    idx_gt_prev = np.clip(idx_gt - 1, 0, len(ts_gt) - 1)
    pick_prev = np.abs(ts_gt[idx_gt_prev] - ts_est) < np.abs(ts_gt[idx_gt] - ts_est)
    idx = np.where(pick_prev, idx_gt_prev, idx_gt)
    ok = np.abs(ts_gt[idx] - ts_est) <= max_dt
    if ok.sum() < 3:
        return float("inf")
    a = pos_est[ok].T  # (3, M) estimated
    b = pos_gt[idx[ok]].T  # (3, M) ground truth
    # Horn closed-form alignment a -> b
    ca, cb = a.mean(1, keepdims=True), b.mean(1, keepdims=True)
    H = (a - ca) @ (b - cb).T
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = cb - R @ ca
    err = R @ a + t - b
    return float(np.sqrt((err**2).sum(0).mean()))
