"""Where the loop orbit's keyframe errors come from.

    python -m plslam_torch.utils.orbit_probe [VARIANT ...] [--frames N] [--out DIR]
                                             [--device cpu --small]

Tracks the orbit of RoomScene(3) (tests/test_loop_closing.py's, 150 frames,
a full turn of yaw in 120) at 640x480 (``--small``: 320x240), points and
lines, keyframe culling off, once per VARIANT:

- ``mapper``: ``AsyncLocalMapper``, no loop closer;
- ``loop``: ``AsyncLocalMapper`` and ``AsyncLoopCloser``, the wiring of
  chip_smoke.py's phase loop;
- ``sync``: a synchronous ``LocalMapper`` and ``LoopCloser``.

For each it records, against ground truth, every keyframe's camera-centre
error relative to keyframe 0 (cm) after every local BA write-back, around
each stage of every loop correction and at the end, the tracked error of
each retired frame, and when gauge corrections were published and applied.
Everything goes to DIR/orbit_probe.json (default ``chiprun_out``); one
summary line per variant goes to stdout. The map just before a variant's
first loop correction goes to DIR/orbit_probe_<variant>_map.npz in the JAX
package's checkpoint layout (its ``utils/checkpoint.py``), with the
correction's arguments and each keyframe's orbit frame, for
``tests/torch_loop_replay.py`` to replay that correction in both packages;
``--dump-end`` also saves each variant's final map as
DIR/orbit_probe_<variant>_end.npz (for ``tests/torch_sever_replay.py``).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing as mp
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .checkpoint import save_map

def orbit_poses(n, radius=0.45):
    """tests/test_loop_closing.py::orbit_poses (world-to-camera)."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / (150 - 30)
        c = np.array([radius * np.sin(a), 0.0, 1.25 + radius * np.cos(a)], np.float32)
        ca, sa = np.cos(a), np.sin(a)
        R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32).T
        poses.append((R, (-R @ c).astype(np.float32)))
    return poses


def _render_chunk(cam, poses, f):
    from .synthetic import RoomScene

    scene = RoomScene(3)
    out = []
    for R, t in poses:
        g, d = scene.render(cam, R, t)
        out.append((np.clip(g, 0, 255).astype(np.uint8),
                    np.clip(d * f, 0, 65535).astype(np.uint16)))
    return out


def render(cam, poses, f, workers):
    with cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(_render_chunk, cam, poses[i:i + 10], f)
                for i in range(0, len(poses), 10)]
        return [fr for fut in futs for fr in fut.result()]


def centre_err(R, t, R0, t0, gR, gt, gR0, gt0):
    """Camera-centre error of (R, t) relative to (R0, t0) against the same
    relative in ground truth, m."""
    Rrel, Rrel_g = R @ R0.T, gR @ gR0.T
    trel, trel_g = t - Rrel @ t0, gt - Rrel_g @ gt0
    return float(np.linalg.norm(-Rrel.T @ trel + Rrel_g.T @ trel_g))


class Recorder:
    """Per-keyframe errors and events of one run."""

    def __init__(self, m, poses):
        self.m, self.poses = m, poses
        self.frame_of = {}   # tracker frame id -> orbit frame
        self.fed = 0
        self.t0 = time.perf_counter()
        self.events = []
        self.tracked = []    # (orbit frame, cm) of each retired frame
        self._lock = threading.Lock()

    def kf_errs(self):
        m, p = self.m, self.poses
        g0 = p[self.frame_of.get(int(m.kf_frame_id[0]), 0)]
        out = {}
        for k in range(m.n_kf):
            f = self.frame_of.get(int(m.kf_frame_id[k]))
            if m.kf_valid[k] and f is not None:
                out[k] = round(100 * centre_err(m.kf_R[k], m.kf_t[k], m.kf_R[0], m.kf_t[0],
                                                *p[f], *g0), 2)
        return out

    def note(self, what, **kw):
        with self._lock:
            self.events.append(dict(event=what, frame=self.fed,
                                    s=round(time.perf_counter() - self.t0, 3), **kw))


def run_variant(variant, cfg, frames, poses, dev, out_dir, dump_end=False):
    from ..bow.database import KeyFrameDatabase
    from ..bow.vocabulary import Vocabulary
    from ..models.async_mapping import AsyncLocalMapper, AsyncLoopCloser
    from ..models.local_mapping import LocalMapper
    from ..models.loop_closing import LoopCloser
    from ..models.map import SlamMap
    from ..models.tracking import Tracker

    voc = Vocabulary.load(device=dev)
    m = SlamMap(cfg, device=dev)
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    inner_lm = LocalMapper(cfg, m, kfdb=kfdb)
    lm = inner_lm if variant == "sync" else AsyncLocalMapper(inner_lm)
    inner_lc = lc = None
    if variant != "mapper":
        inner_lc = LoopCloser(cfg, m, kfdb, voc, local_mapper=lm)
        lc = inner_lc if variant == "sync" else AsyncLoopCloser(inner_lc)
    tr = Tracker(cfg, m, local_mapper=lm, loop_closer=lc, voc=voc, kfdb=kfdb)
    if lc is not None:
        lc.tracker = tr
    rec = Recorder(m, poses)
    dumped = []

    write_back = inner_lm._write_back_ba

    def _write_back_ba(g, *a):
        before = rec.kf_errs()
        write_back(g, *a)
        after = rec.kf_errs()
        moved = {k: round(after[k] - before.get(k, 0.0), 2) for k in after
                 if abs(after[k] - before.get(k, 0.0)) > 0.5}
        rec.note("ba", cams=[int(c) for c, f in zip(g.cams, g.cam_fixed) if not f],
                 n_cams=len(g.cams), moved_cm=moved, max_err_cm=max(after.values()))

    inner_lm._write_back_ba = _write_back_ba

    if inner_lc is not None:
        def staged(name):
            fn = getattr(inner_lc, name)

            def run(*a, **kw):
                out = fn(*a, **kw)
                with inner_lc.lock:
                    rec.note(name.lstrip("_"), n_kf=m.n_kf, kf_err_cm=rec.kf_errs())
                return out
            return run

        for name in ("_propagate_group", "_optimize_essential_graph", "_global_ba"):
            setattr(inner_lc, name, staged(name))
        correct = inner_lc._correct_loop

        def _correct_loop(kf1, kf2, R12, t12, s12=1.0):
            with inner_lc.lock:
                rec.note("correct_loop_begin", kf1=int(kf1), kf2=int(kf2), n_kf=m.n_kf,
                         kf_err_cm=rec.kf_errs())
                if not dumped:
                    path = Path(out_dir) / f"orbit_probe_{variant}_map.npz"
                    fid = m.kf_frame_id[:m.n_kf]
                    save_map(m, path, dict(
                        kf1=np.int64(kf1), kf2=np.int64(kf2), R12=np.asarray(R12, np.float32),
                        t12=np.asarray(t12, np.float32), s12=np.float32(s12),
                        kf_orbit_frame=np.array([rec.frame_of.get(int(f), -1) for f in fid])))
                    dumped.append(str(path))
            correct(kf1, kf2, R12, t12, s12)
            with inner_lc.lock:
                rec.note("correct_loop_end", n_kf=m.n_kf, kf_err_cm=rec.kf_errs())

        inner_lc._correct_loop = _correct_loop

    publish, apply_ = tr.apply_gauge_correction, tr._apply_pending_gauge

    def apply_gauge_correction(R, t):
        rec.note("gauge_published", shift_cm=round(100 * float(np.linalg.norm(t)), 2))
        publish(R, t)

    def _apply_pending_gauge():
        pending = tr._pending_gauge is not None
        apply_()
        if pending:
            rec.note("gauge_applied")

    tr.apply_gauge_correction, tr._apply_pending_gauge = apply_gauge_correction, \
        _apply_pending_gauge

    def retire(out):
        if out is None:
            return
        ts, R, t = tr.trajectory[-1]
        f = int(round(ts * 30))
        with tr._map_lock:
            g0 = poses[rec.frame_of.get(int(m.kf_frame_id[0]), 0)]
            rec.tracked.append((f, round(100 * centre_err(R, t, m.kf_R[0], m.kf_t[0],
                                                          *poses[f], *g0), 2)))

    t0 = time.perf_counter()
    try:
        for i, (g, d) in enumerate(frames):
            out = tr.process(g, d, i / 30.0)
            rec.frame_of[tr.frame_id] = i
            rec.fed = i + 1
            retire(out)
        tr.flush()
        if variant != "sync":
            for w in (lm, lc, lm) if lc is not None else (lm,):
                if not w.wait_idle(timeout=300.0):
                    raise RuntimeError(f"{type(w).__name__} still busy after 300 s")
    finally:
        if variant != "sync":
            if lc is not None:
                lc.shutdown()
            lm.shutdown()
    for w in (lm, lc):
        if getattr(w, "error", None) is not None:
            raise RuntimeError(f"worker error: {w.error!r}")
    if dump_end:
        path = Path(out_dir) / f"orbit_probe_{variant}_end.npz"
        save_map(m, path, dict(kf_orbit_frame=np.array(
            [rec.frame_of.get(int(f), -1) for f in m.kf_frame_id[:m.n_kf]])))
        dumped.append(str(path))
    errs = rec.kf_errs()
    res = dict(variant=variant, seconds=round(time.perf_counter() - t0, 1),
               frames=len(frames), retired=len(tr.trajectory), keyframes=m.n_kf,
               kf_orbit_frame=[rec.frame_of.get(int(f), -1) for f in m.kf_frame_id[:m.n_kf]],
               loops_closed=getattr(lc, "n_loops_closed", 0),
               loop_edges=[list(map(int, e)) for e in m.loop_edges],
               kf_err_cm=errs, max_kf_err_cm=max(errs.values()),
               final_tracked_err_cm=rec.tracked[-1][1] if rec.tracked else None,
               tracked_err_cm=rec.tracked, events=rec.events, map_dump=dumped)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=["mapper", "loop"])
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="320x240 instead of 640x480")
    ap.add_argument("--workers", type=int, default=6, help="rendering processes")
    ap.add_argument("--dump-end", action="store_true",
                    help="also save each variant's final map (orbit_probe_<variant>_end.npz)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("orbit_probe: CUDA is not available", file=sys.stderr)
        return 1
    from ..config import SlamConfig
    from ..geometry.projection import Camera

    cam = (Camera(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=40.0, width=320, height=240)
           if args.small else Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    cfg = SlamConfig(camera=cam, use_lines=True)
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping,
                                                               kf_culling_redundancy=10.0))
    poses = orbit_poses(args.frames)
    frames = render(cam, poses, cfg.tracking.depth_map_factor, args.workers)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    results = []
    for v in args.variants:
        r = run_variant(v, cfg, frames, poses, torch.device(args.device), args.out,
                        args.dump_end)
        results.append(r)
        print(json.dumps({k: r[k] for k in ("variant", "seconds", "retired", "keyframes",
                                            "loops_closed", "loop_edges", "max_kf_err_cm",
                                            "final_tracked_err_cm", "kf_err_cm")}), flush=True)
        with open(Path(args.out) / "orbit_probe.json", "w") as fh:
            json.dump(results, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
