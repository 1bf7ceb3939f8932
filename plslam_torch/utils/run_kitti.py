"""Run the port on a KITTI odometry stereo sequence — the ``stereo_kitti``
equivalent (Examples/Stereo/stereo_kitti.cc of the reference), the port's
counterpart of the repository's ``scripts/run_kitti.py``.

Usage:
  python -m plslam_torch.utils.run_kitti SETTINGS.yaml SEQUENCE_DIR
      [--out results/] [--max-frames N] [--device cuda|cpu]

SEQUENCE_DIR is a KITTI odometry sequence folder (image_0/, image_1/,
times.txt). Tracks every rectified pair through ``System(sensor="stereo")``
(no lines: the reference's stereo frame extracts none), writes the
KITTI-format trajectory CameraTrajectory.txt and prints the median / mean
tracking time (rgbd_tum.cc:141-149). Images are read with the PNG decoder
of ``plslam_torch.native`` (no OpenCV). ``--device`` picks the device
(default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m plslam_torch.utils.run_kitti")
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="results")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap.parse_args(argv)


def load_gray(path: str) -> np.ndarray:
    """One KITTI image as uint8 gray, through the native PNG decoder: the
    first channel of a gray or gray+alpha file, 0.299 R + 0.587 G + 0.114 B
    rounded for a color one; 16-bit samples keep their high byte."""
    from ..native import read_png

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[2] >= 3:
        rgb = img[..., :3].astype(np.float32)
        gray = np.float32(0.299) * rgb[..., 0] + np.float32(0.587) * rgb[..., 1] \
            + np.float32(0.114) * rgb[..., 2]
        return np.clip(np.rint(gray), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img[..., 0])


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import load_yaml
    from ..models.system import System

    cfg = load_yaml(args.settings).replace(use_lines=False)
    slam = System(cfg, tune_gc=True, enable_loop_closing=True, sensor="stereo",
                  device=args.device)
    times = np.atleast_1d(np.loadtxt(os.path.join(args.sequence, "times.txt")))
    n = len(times) if not args.max_frames else min(args.max_frames, len(times))
    lat = []
    for i in range(n):
        name = f"{i:06d}.png"
        gl = load_gray(os.path.join(args.sequence, "image_0", name))
        gr = load_gray(os.path.join(args.sequence, "image_1", name))
        t0 = time.perf_counter()
        slam.track_stereo(gl, gr, float(times[i]))
        lat.append(time.perf_counter() - t0)
    slam.shutdown()

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_kitti(os.path.join(args.out, "CameraTrajectory.txt"))
    lat = np.array(lat)
    print(f"final state:          {slam.tracking_state}")
    print(f"median tracking time: {np.median(lat):.4f}")
    print(f"mean tracking time:   {lat.mean():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
