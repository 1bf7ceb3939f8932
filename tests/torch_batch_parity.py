"""Where a batched step first differs from the same step alone.

    python tests/torch_batch_parity.py [--device cuda] [--batch 4] [--warm 5]

Tracks ``warm`` frames of the 640x480 room alone, then runs the next frame's
fused step once alone and once in a batch of ``batch`` copies of the same
problem (``parallel.multiseq.batched_step``), recording the outputs of every
stage on the way (ORB, LSD, LBD, the frame, each pose LM, the motion and
local steps). Prints one line per stage call: whether batch entry 0 equals
the solo result bit for bit, and the largest difference. Not a test: a
probe for the card, where reductions and library products may take another
order in a batch.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plslam_torch.config import SlamConfig  # noqa: E402
from plslam_torch.geometry.projection import Camera  # noqa: E402
from plslam_torch.models import frame as mframe  # noqa: E402
from plslam_torch.models import tracking as T  # noqa: E402
from plslam_torch.models.map import SlamMap  # noqa: E402
from plslam_torch.ops import fast, image, lbd, lsd, orb  # noqa: E402
from plslam_torch.optim import pose as pose_opt  # noqa: E402
from plslam_torch.parallel import multiseq  # noqa: E402
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory  # noqa: E402

STAGES = [(orb, "extract_orb"), (lsd, "detect_lines"), (lbd, "lbd_descriptors"),
          (mframe, "build_frame"), (pose_opt, "optimize_pose"), (T, "_motion_core"),
          (T, "_local_core")]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _record(calls):
    saved = []
    for mod, name in STAGES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            calls.append((_name, [t.clone() for t in _leaves(out)]))
            return out
        setattr(mod, name, wrapped)
    return saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--sequence", type=int, default=0,
                    help="instead: track this many frames alone and, as entry 1 of a "
                         "batch of 2, with a synchronous mapper and a wrong velocity "
                         "prior at --warm, and compare every step's outputs")
    ap.add_argument("--scene", type=int, default=0, help="RoomScene seed")
    args = ap.parse_args()
    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    if args.sequence:
        return sequence(cfg, args)
    scene = RoomScene(0)
    frames = []
    for R, t in smooth_trajectory(300)[:args.warm + 1]:
        g, d = scene.render(cfg.camera, R, t)
        frames.append((np.clip(g, 0, 255).astype(np.uint8),
                       np.clip(d * cfg.tracking.depth_map_factor, 0, 65535).astype(np.uint16)))
    tr = T.Tracker(cfg, SlamMap(cfg, device=args.device))
    for i in range(args.warm):
        tr.process(*frames[i], i / 30.0)
    g, d = tr._inputs_to_device(*frames[-1])
    a = tr.dispatch_args()
    runs = []
    for batched in (False, True):
        calls = []
        saved = _record(calls)
        try:
            if batched:
                B = args.batch
                multiseq.batched_step(cfg, torch.stack([g] * B), torch.stack([d] * B),
                                      multiseq.stack_args([a] * B))
            else:
                T.fused_track_step(cfg, g, d, *a)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        runs.append(calls)
    print(f"device {torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}, "
          f"batch {args.batch}")
    for (name, solo), (bname, bat) in zip(*runs):
        assert name == bname, (name, bname)
        print(f"  {name:16s} {_compare(solo, bat)}")
    # the ORB pipeline's operations on level 0 of this frame, alone and on a
    # stack of copies
    img = mframe._unquantize_gray(g, cfg).float()
    lv = image.build_pyramid(img, cfg.orb.n_levels, cfg.orb.scale_factor)
    bl = image.build_pyramid(torch.stack([img] * args.batch), cfg.orb.n_levels,
                             cfg.orb.scale_factor)
    print(f"  pyramid          {_compare(lv, bl)}")
    x = lv[1]
    xs = torch.stack([x] * args.batch)
    score = fast.fast_score_nms(x, 7.0)
    ys, xs_, resp = fast.detect_cellwise(score, 20.0, 30, 12, 19)
    ys, xs_, resp, _ = fast.top_n_keypoints(ys, xs_, resp, 200)
    bys, bxs = torch.stack([ys] * args.batch), torch.stack([xs_] * args.batch)
    ops = {
        "fast": lambda z: fast.fast_score_nms(z, 7.0),
        "cellwise": lambda z: fast.detect_cellwise(fast.fast_score_nms(z, 7.0), 20.0, 30, 12, 19),
        "cumsum": lambda z: torch.cumsum(z, -1),
        "moments": orb.ic_moment_maps,
        "blur": image.gaussian_blur,
        "ic_angles": lambda z: orb.ic_angles(z, ys if z.dim() == 2 else bys,
                                             xs_ if z.dim() == 2 else bxs),
    }
    for name, fn in ops.items():
        print(f"  {name:16s} {_compare(_leaves(fn(x)), _leaves(fn(xs)))}")


def sequence(cfg, args):
    """Every fused step's outputs of a sequence tracked alone against the
    same sequence as entry 1 of a batch of two (entry 0 the same frames
    again), both with a synchronous mapper and a wrong velocity prior before
    frame ``warm``; prints the first steps that differ and how."""
    from plslam_torch.models.local_mapping import LocalMapper

    scene = RoomScene(args.scene)
    frames = []
    for R, t in smooth_trajectory(2 * args.sequence)[:args.sequence]:
        g, d = scene.render(cfg.camera, R, t)
        frames.append((np.clip(g, 0, 255).astype(np.uint8),
                       np.clip(d * cfg.tracking.depth_map_factor, 0, 65535).astype(np.uint16)))

    def tracker():
        m = SlamMap(cfg, device=args.device)
        return T.Tracker(cfg, m, local_mapper=LocalMapper(cfg, m))

    def wrong(tr):
        c, s_ = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
        tr._R_vel = torch.tensor([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], dtype=torch.float32,
                                 device=args.device)
        tr._t_vel = torch.tensor([0.4, 0.0, 0.0], device=args.device)

    outs = {"solo": [], "batch": []}
    which = ["solo"]
    hooked = [(T, "fused_track_step"), (T, "_rescue_core"), (T, "_motion_core"),
              (T, "_local_core"), (pose_opt, "optimize_pose")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in hooked]

    def recorder(name, fn):
        def run(*a, **k):
            if name == "optimize_pose":  # its inputs too
                outs[which[0]].append((name + " in", [t.clone() for t in _leaves(a)]))
            out = fn(*a, **k)
            outs[which[0]].append((name, [t.clone() for t in _leaves(out)]))
            return out
        return run

    for mod, name, fn in saved:
        setattr(mod, name, recorder(name, fn))
    try:
        solo = tracker()
        for i, f in enumerate(frames):
            if i == args.warm:
                wrong(solo)
            solo.process(*f, i / 30.0)
        solo.flush()
        which[0] = "batch"
        trs = [tracker(), tracker()]
        mt = multiseq.MultiTracker(trs)
        for i, f in enumerate(frames):
            if i == args.warm:
                wrong(trs[1])
            mt.process([f, f], [i / 30.0] * 2)
        mt.flush()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(f"device {torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}, "
          f"{len(outs['solo'])} solo calls, {len(outs['batch'])} batched calls")
    shown = 0
    for i, ((name, a), (bname, b)) in enumerate(zip(outs["solo"], outs["batch"])):
        assert name == bname, (i, name, bname)
        # a batched call's leaves carry the batch axis: entry 1 is the
        # sequence; the rescue's carry a sub-batch of one
        bb = [y[1] if y.dim() > x.dim() and y.shape[0] == 2 else y for x, y in zip(a, b)]
        res = _compare(a, bb)
        if res != "equal" and shown < 6:
            print(f"  call {i} {name}: {res}")
            shown += 1
    d = [float(np.linalg.norm(-(Ra.T @ ta) + Rb.T @ tb))
         for (_, Ra, ta), (_, Rb, tb) in zip(solo.trajectory, trs[1].trajectory)]
    print("  centre differences by row (m):", " ".join(f"{x:.2g}" for x in d))


def _compare(solo, bat):
    """'equal', or which leaves differ, by how much and in how many elements."""
    out = []
    for k, (x, y) in enumerate(zip(solo, bat)):
        y0 = y[0] if y.dim() > x.dim() else y
        if not torch.equal(x, y0):
            d = (x.double() - y0.double()).abs()
            out.append(f"#{k} {tuple(x.shape)}: {int((d > 0).sum())} differ, max {float(d.max()):.3g}")
    return "; ".join(out) if out else "equal"


if __name__ == "__main__":
    main()
