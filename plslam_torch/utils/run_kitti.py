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
tracking time (rgbd_tum.cc:141-149). Images are read with OpenCV; on a host
without it the runner exits with an error (the native PNG loader is
ROADMAP.md Queue A item 18). ``--device`` picks the device (default
``cuda``).
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
    """One KITTI image as uint8 gray (OpenCV, imported here only)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("run_kitti: OpenCV (cv2) is not installed and the native PNG loader is "
              "not ported (ROADMAP.md Queue A item 18)", file=sys.stderr)
        return 2

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
