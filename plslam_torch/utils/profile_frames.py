"""Where a tracked frame's time goes on the GPU.

    python -m plslam_torch.utils.profile_frames [--frames 3] [--warm 20] [--batch B]

Renders the synthetic room (640x480, the chip_smoke.py sequence), tracks
``warm`` frames, then profiles the next ``frames`` with ``torch.profiler``
(device activity only: a frame launches tens of thousands of kernels, and
host-op tracing on top of that takes minutes to post-process) and prints:
host wall time per frame, the device-busy share (the union of kernel
intervals over the window), the top CUDA kernels by device time, and the
host time per tracker stage (host clock, no synchronisation inside).
With ``--batch B`` it tracks B sequences (RoomScene(0..B-1) on the same
trajectory) through one ``parallel.multiseq.MultiTracker``, and every
number is per batched step of B sequence-frames.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _busy_ms(events) -> float:
    """Union length (ms) of the device kernel intervals."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames: needs a CUDA GPU")

    from torch.profiler import ProfilerActivity, profile

    from ..config import SlamConfig
    from ..geometry.projection import Camera
    from ..models import tracking
    from ..models.map import SlamMap
    from ..parallel.multiseq import MultiTracker
    from .synthetic import RoomScene, smooth_trajectory

    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    n = args.warm + args.frames
    seqs = []
    for seed in range(args.batch):
        scene = RoomScene(seed)
        frames = []
        for R, t in smooth_trajectory(300)[:n]:
            g, d = scene.render(cfg.camera, R, t)
            frames.append((np.clip(g, 0, 255).astype(np.uint8),
                           np.clip(d * cfg.tracking.depth_map_factor, 0,
                                   65535).astype(np.uint16)))
        seqs.append(frames)
    trackers = [tracking.Tracker(cfg, SlamMap(cfg, device="cuda")) for _ in seqs]
    if args.batch == 1:
        step = lambda i: trackers[0].process(*seqs[0][i], i / 30.0)  # noqa: E731
    else:
        mt = MultiTracker(trackers)
        step = lambda i: mt.process([q[i] for q in seqs], [i / 30.0] * len(seqs))  # noqa: E731
    for i in range(args.warm):
        step(i)
    torch.cuda.synchronize()

    # time the stages of the fused step on the host clock (pose nests inside
    # motion and local)
    stages = {"build_frame": (tracking.mframe, "build_frame"),
              "motion": (tracking, "_motion_core"),
              "local": (tracking, "_local_core"),
              "pose": (tracking.pose_opt, "optimize_pose"),
              "finish": (tracking.Tracker, "_finish")}
    originals = {}
    stage_s = dict.fromkeys(stages, 0.0)
    for label, (owner, name) in stages.items():
        fn = getattr(owner, name)
        originals[label] = (owner, name, fn)

        def wrapped(*a, _fn=fn, _label=label, **k):
            s = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                stage_s[_label] += time.perf_counter() - s
        setattr(owner, name, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(args.warm, n):
                step(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, name, fn in originals.values():
            setattr(owner, name, fn)

    events = prof.events()
    busy = _busy_ms(events)
    ka = prof.key_averages()
    kernels = sorted((k for k in ka if k.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda k: -k.device_time_total)[:15]
    stage_ms = {k: v * 1e3 / args.frames for k, v in stage_s.items()}
    print(json.dumps({
        "sequences": args.batch, "device": torch.cuda.get_device_name(0),
        "frames": args.frames, "wall_ms_per_frame": wall / args.frames,
        "device_busy_ms_per_frame": busy / args.frames,
        "device_idle_share": 1.0 - busy / wall,
        "host_stage_ms_per_frame": stage_ms,
        "cuda_launches_per_frame": sum(k.count for k in ka
                                       if k.device_type == torch.autograd.DeviceType.CUDA)
        / args.frames,
    }))
    for k in kernels:
        print(f"  {k.device_time_total / 1e3 / args.frames:8.3f} ms/frame "
              f"{k.count / args.frames:7.1f} calls/frame  {k.key[:90]}")


if __name__ == "__main__":
    main()
