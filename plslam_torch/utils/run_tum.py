"""Run the port on a TUM RGB-D sequence — the ``rgbd_my`` equivalent
(Examples/RGB-D/rgbd_my.cpp of the reference), the port's counterpart of
the repository's ``scripts/run_tum.py``.

Usage:
  python -m plslam_torch.utils.run_tum SETTINGS.yaml ASSOC.txt [--root SEQ_DIR]
      [--out results/] [--no-lines] [--no-loop] [--pcd] [--max-frames N]
      [--sync] [--compact-every N] [--save-raw] [--native-loader]
      [--device cuda|cpu]

Reads the reference's settings YAML format, tracks every associated frame
(read with OpenCV, or with ``--native-loader`` through the native
prefetching loader of ``plslam_torch.native``, which decodes PNG itself and
needs no OpenCV), prints per-frame timing stats (median / mean like
rgbd_tum.cc:141-149), and writes CameraTrajectory.txt and
KeyFrameTrajectory.txt (+ result.pcd with --pcd, + CameraTrajectoryRaw.txt,
the unhealed trajectory, with --save-raw). ``--device`` picks the device
(default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m plslam_torch.utils.run_tum")
    ap.add_argument("settings")
    ap.add_argument("assoc")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default="results")
    ap.add_argument("--no-lines", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--pcd", action="store_true")
    ap.add_argument("--native-loader", action="store_true",
                    help="read frames through the native prefetching loader "
                         "(plslam_torch.native: its own PNG decoder, 4 decode threads)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--sync", action="store_true",
                    help="run mapping + loop closing synchronously in the frame loop "
                         "(default: async workers, the reference's thread architecture, "
                         "System.cc:86-118)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="reclaim erased landmark arena slots every N frames "
                         "(System.compact_map drains the pipeline at a safe point first)")
    ap.add_argument("--save-raw", action="store_true",
                    help="also save the AS-TRACKED (unhealed) trajectory as "
                         "CameraTrajectoryRaw.txt for healed-vs-raw ATE comparison")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..config import load_yaml
    from ..models.system import System
    from . import tum_io

    cfg = load_yaml(args.settings)
    if args.no_lines:
        cfg = cfg.replace(use_lines=False)
    slam = System(cfg, tune_gc=True, enable_loop_closing=not args.no_loop,
                  enable_dense_cloud=args.pcd, async_mapping=not args.sync,
                  device=args.device)

    root = args.root or os.path.dirname(os.path.abspath(args.assoc))
    if args.native_loader:
        from ..native import TumLoader

        frames = TumLoader(args.assoc, root, cfg.tracking.depth_map_factor,
                           width=cfg.camera.width, height=cfg.camera.height)
        n_total = len(frames)
    else:
        assoc = tum_io.load_association(args.assoc, root)
        n_total = len(assoc.timestamps)
        frames = ((*tum_io.load_rgb_depth(assoc.rgb_paths[i], assoc.depth_paths[i],
                                          cfg.tracking.depth_map_factor),
                   assoc.timestamps[i]) for i in range(n_total))
    times = []
    n = 0
    for gray, depth, ts in frames:
        t0 = time.perf_counter()
        slam.track_rgbd(gray, depth, ts)
        times.append(time.perf_counter() - t0)
        n += 1
        if n % 50 == 0:
            print(f"[{n}/{n_total}] state={slam.tracking_state} "
                  f"kfs={slam.map.n_kf} pts={slam.map.n_points()} "
                  f"lines={slam.map.n_lines()} "
                  f"median {np.median(times) * 1000:.1f} ms/frame", flush=True)
        if args.compact_every and n % args.compact_every == 0:
            slam.compact_map()
        if args.max_frames and n >= args.max_frames:
            break
    if args.native_loader:
        frames.close()  # stops the decode threads

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "CameraTrajectory.txt"))
    if args.save_raw:
        tr = slam.tracker
        tum_io.save_trajectory_tum(
            os.path.join(args.out, "CameraTrajectoryRaw.txt"),
            [t for t, _, _ in tr.trajectory],
            [(R.T, -(R.T @ t)) for _, R, t in tr.trajectory])
    slam.save_keyframe_trajectory_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"))
    if args.pcd:
        slam.save_pcd(os.path.join(args.out, "result.pcd"))
    slam.shutdown()
    errors = [w.error for w in (slam.local_mapper, slam.loop_closer)
              if getattr(w, "error", None) is not None]
    if errors:
        print(f"a worker failed: {errors[0]!r}", file=sys.stderr)
        return 1

    times = np.array(times[3:])  # the first frames initialize
    print("-------")
    print(f"final state:          {slam.tracking_state}")
    if len(times):
        print(f"median tracking time: {np.median(times) * 1000:.1f} ms")
        print(f"mean tracking time:   {times.mean() * 1000:.1f} ms")
        print(f"tracked fps:          {1.0 / np.median(times):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
