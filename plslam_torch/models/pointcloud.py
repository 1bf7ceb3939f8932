"""Dense point-cloud mapping.

The port of the JAX package's ``models/pointcloud.py``, a re-design of the
reference's ``PointCloudMapping`` thread (PointCloudMapping.cc): every
keyframe contributes a subsampled back-projection of its depth map (every
3rd pixel, 0.01 < d < 10, :63-119), accumulated into a voxel-deduplicated
global cloud (1 cm grid, :120-160) and rebuilt from corrected keyframe poses
after a loop (is_loop_, :168-176). The thread and its condition variable
disappear: the unprojection is one batch of tensor ops per keyframe on the
map's device, and the voxel dedup is a hash on quantized coordinates on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig


def _recip32(v: float) -> float:
    return float(np.float32(1.0) / np.float32(v))


def unproject_keyframe(cfg: SlamConfig, gray: torch.Tensor, depth: torch.Tensor,
                       R: torch.Tensor, t: torch.Tensor):
    """Back-project an ALREADY-STRIDED depth image to world points (the
    mapper keeps only every ``pixel_stride``-th pixel per keyframe —
    PointCloudMapping.cc:63-119 keeps every 3rd), in float32 and in the JAX
    package's order of operations. Its compiler turns the division by a
    focal length into a product with the float32 reciprocal, and so does
    this function.

    Returns (xyz (M, 3), intensity (M,), valid (M,))."""
    cam = cfg.camera
    s = cfg.cloud.pixel_stride
    d = depth
    h, w = d.shape
    dev = d.device
    vs = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) * s
    us = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) * s
    ok = (d > cfg.cloud.depth_min) & (d < cfg.cloud.depth_max)
    x = (us - cam.cx) * _recip32(cam.fx) * d
    y = (vs - cam.cy) * _recip32(cam.fy) * d
    pc = torch.stack([x, y, d], -1).reshape(-1, 3)
    Rwc = R.T
    c = -(Rwc @ t)
    pw = pc @ Rwc.T + c
    return pw, gray.reshape(-1), ok.reshape(-1)


class PointCloudMapper:
    """Accumulates voxel-deduplicated dense geometry per keyframe."""

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.voxels: dict[tuple, tuple] = {}
        self.kf_inputs: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # amortized loop-rebuild state: keyframes pending re-accumulation
        # against the pose snapshot taken at mark_dirty time
        self._rebuild_queue: list[int] = []
        self._rebuild_poses: tuple | None = None

    def insert_keyframe(self, kf: int, gray: np.ndarray, depth: np.ndarray,
                        R: np.ndarray, t: np.ndarray):
        # keep only the strided samples (the rebuild working set: ~75 KB/KF
        # at stride 3 instead of 2.4 MB full-res)
        s = self.cfg.cloud.pixel_stride
        g = np.ascontiguousarray(gray[::s, ::s], np.float32)
        d = np.ascontiguousarray(depth[::s, ::s], np.float32)
        self.kf_inputs[kf] = (g, d)
        self._accumulate(g, d, R, t)

    def _accumulate(self, gray, depth, R, t):
        up = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        pw, inten, ok = unproject_keyframe(self.cfg, up(gray), up(depth), up(R), up(t))
        pw = pw[ok].cpu().numpy()
        inten = inten[ok].cpu().numpy()
        q = np.floor(pw / self.cfg.cloud.voxel_size).astype(np.int64)
        # voxel hash dedup (keep first sample per voxel)
        keys = q[:, 0] * 73856093 ^ q[:, 1] * 19349663 ^ q[:, 2] * 83492791
        _, first = np.unique(keys, return_index=True)
        for i in first:
            self.voxels[tuple(q[i])] = (pw[i], inten[i])

    def mark_dirty(self, slam_map):
        """Schedule a rebuild from (corrected) keyframe poses — the
        reference's loop-triggered rebuild (PointCloudMapping.cc:168-176),
        which runs on the viewer thread there; here the re-accumulation is
        amortized over subsequent ``step`` calls so the frame loop never
        stalls for a full-map rebuild. Caller must hold the map lock: the
        pose snapshot taken here is what the rebuild uses, so async
        mapper/loop workers can keep writing poses afterwards without
        tearing the cloud."""
        n = getattr(slam_map, "n_kf", len(slam_map.kf_valid))
        self._rebuild_poses = (np.array(slam_map.kf_R[:n]),
                               np.array(slam_map.kf_t[:n]),
                               np.array(slam_map.kf_valid[:n]))
        self._rebuild_queue = [k for k in self.kf_inputs if k < n]
        self.voxels.clear()

    def step(self, budget: int = 2):
        """Re-accumulate up to ``budget`` pending keyframes (call once per
        tracked frame; a loop rebuild of K keyframes finishes K/budget
        frames later instead of stalling one frame for seconds)."""
        while budget > 0 and self._rebuild_queue:
            kf = self._rebuild_queue.pop()
            R, t, valid = self._rebuild_poses
            if valid[kf]:
                gray, depth = self.kf_inputs[kf]
                self._accumulate(gray, depth, R[kf], t[kf])
            budget -= 1

    def drain(self):
        """Finish any pending rebuild synchronously (savers call this)."""
        self.step(budget=len(self._rebuild_queue))

    def rebuild(self, slam_map):
        """Synchronous full rebuild (mark_dirty + drain)."""
        self.mark_dirty(slam_map)
        self.drain()

    def cloud(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.voxels:
            return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
        pts = np.stack([v[0] for v in self.voxels.values()])
        inten = np.array([v[1] for v in self.voxels.values()], np.float32)
        return pts, inten

    def save_pcd(self, path: str):
        """ASCII PCD, byte for byte as the JAX package writes it (the
        reference saves result.pcd via PCL, System.cc:507)."""
        pts, inten = self.cloud()
        with open(path, "w") as f:
            f.write("# .PCD v0.7 - Point Cloud Data file format\n")
            f.write("VERSION 0.7\nFIELDS x y z intensity\n")
            f.write("SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n")
            f.write(f"WIDTH {len(pts)}\nHEIGHT 1\n")
            f.write("VIEWPOINT 0 0 0 1 0 0 0\n")
            f.write(f"POINTS {len(pts)}\nDATA ascii\n")
            for p, i in zip(pts, inten):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {i:.1f}\n")
