"""Tracked frames/s of the full RGB-D point+line pipeline on the GPU.

    python -m plslam_torch.utils.bench

The port of the repository's ``bench.py`` driver: the same synthetic room,
camera and 150 frames (640x480 uint8 gray, uint16 depth), tracked by
``Tracker`` with ``AsyncLocalMapper(LocalMapper(...))``, the reference's
thread split (tracking timed while local mapping runs on its own thread).
One rehearsal pass, then best-of-N timed passes (``BENCH_PASSES``, default
3; ``BENCH_FRAMES`` cuts the sequence). A pass is timed from its first
``process`` to ``flush`` plus a device synchronisation; the mapper then
drains and stops outside the timed window, and a mapper error fails the
run. Per-pass fps go to stderr; the last line of stdout is one JSON object
with ``tracked_fps_640x480_points+lines`` and the device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 1
    from ..config import SlamConfig
    from ..geometry.projection import Camera
    from ..models.async_mapping import AsyncLocalMapper
    from ..models.local_mapping import LocalMapper
    from ..models.map import SlamMap
    from ..models.tracking import Tracker
    from .synthetic import RoomScene, smooth_trajectory

    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    n_frames = int(os.environ.get("BENCH_FRAMES", "150"))
    passes = int(os.environ.get("BENCH_PASSES", "3"))
    scene = RoomScene(0)
    f = cfg.tracking.depth_map_factor
    frames = []
    for R, t in smooth_trajectory(2 * n_frames)[:n_frames]:
        gray, depth = scene.render(cfg.camera, R, t)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8),
                       np.clip(depth * f, 0, 65535).astype(np.uint16)))

    def run() -> float:
        m = SlamMap(cfg)
        mapper = AsyncLocalMapper(LocalMapper(cfg, m))
        tracker = Tracker(cfg, m, local_mapper=mapper)
        t0 = time.perf_counter()
        for i, (gray, depth) in enumerate(frames):
            tracker.process(gray, depth, i / 30.0)
        tracker.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mapper.wait_idle()
        mapper.shutdown()
        if mapper.error is not None:
            raise RuntimeError("local mapping failed") from mapper.error
        if len(tracker.trajectory) != n_frames:
            raise RuntimeError(f"{len(tracker.trajectory)} of {n_frames} frames tracked")
        return n_frames / dt

    run()  # rehearsal: first use of every kernel and allocation
    fps = 0.0
    for i in range(passes):
        f_i = run()
        print(f"[bench] pass {i}: {f_i:.3f} fps", file=sys.stderr, flush=True)
        fps = max(fps, f_i)
    print(json.dumps({
        "metric": "tracked_fps_640x480_points+lines", "value": fps, "unit": "frames/s",
        "vs_baseline": fps / 30.0,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
