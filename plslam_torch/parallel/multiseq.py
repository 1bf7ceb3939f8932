"""Multi-sequence batch tracking: data parallelism over video streams.

The reference processes one video stream per process; its only parallelism
is the threads that share that stream's map. A tracked frame of this port
is host-bound: tens of thousands of small eager launches, each costing the
host more than the card. Tracking B independent sequences in ONE batched
step shares every launch among the B streams: the sequence axis is written
out through the whole fused step, and each hand kernel (FAST over B x 8
pyramid levels, the gated Hamming top-2 with one query set per sequence)
launches once for all B. The serving mode for robot fleets and dataset
sweeps.

Each sequence keeps its own host state machine, map and mapper; only the
per-frame device step is shared. Sequences that are not tracking (the
bootstrap, LOST and relocalization) step solo until they rejoin the batch,
so the results equal those of B trackers run one by one.

Port of the JAX package's ``parallel/multiseq.py``. Repaired here: a batch
mixes no sensors (the JAX frontend takes the first batched tracker's stereo
flag for all, so a stereo tracker batched behind an RGB-D one would have its
right image read as depth), and a tracker's pending gauge correction and VO
retry (``Tracker.begin_frame``) run before its step's arguments are read,
not after the step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import SlamConfig
from ..models import tracking as T
from ..models.frame import FrameData
from ..utils import tracing


def stack_args(args: list[tuple]) -> tuple:
    """B trackers' ``dispatch_args`` stacked along a new leading axis: every
    tensor (and FrameData field) stacked, the Python ``has_vel`` flags a
    (B,) bool tensor."""
    dev = args[0][0].kp_valid.device
    out = []
    for xs in zip(*args):
        if isinstance(xs[0], FrameData):
            out.append(FrameData(*(torch.stack(f) for f in zip(*xs))))
        elif isinstance(xs[0], bool):
            out.append(torch.tensor(xs, dtype=torch.bool, device=dev))
        else:
            out.append(torch.stack(xs))
    return tuple(out)


def batched_step(cfg: SlamConfig, gray: torch.Tensor, depth: torch.Tensor, args: tuple,
                 stereo: bool = False) -> T.FusedOut:
    """The fused track step of B sequences at once: ``gray`` (B, H, W),
    ``depth`` (B, h, w) (the right images with ``stereo=True``) and
    ``args`` from :func:`stack_args`. Row b of every output is sequence b's."""
    return T.fused_track_step(cfg, gray, depth, *args, stereo=stereo)


def slice_out(out: T.FusedOut, b: int) -> T.FusedOut:
    """Sequence b's step of a batched one, as tensors of its own. The
    tracker keeps them (the next step's prior frame, a keyframe's frame for
    the mapper), and a view would sit at an offset in the batch's memory:
    library kernels that pick their code by a pointer's alignment (cuBLAS)
    would round otherwise on it than on a solo tracker's tensors."""
    return T.FusedOut(FrameData(*(x[b].clone() for x in out.fd)),
                      *(x[b].clone() for x in out[1:]))


class MultiTracker:
    """Drive B trackers with one batched device step per frame."""

    def __init__(self, trackers):
        self.trackers = list(trackers)
        if not self.trackers:
            raise ValueError("need at least one tracker")
        first = self.trackers[0]
        if any(t.cfg != first.cfg for t in self.trackers):
            raise ValueError("all trackers must share one SlamConfig")
        sensors = {t.sensor for t in self.trackers}
        if len(sensors) != 1:
            raise ValueError(f"trackers of one batch share one sensor, got {sorted(sensors)}")
        if len({t.device for t in self.trackers}) != 1:
            raise ValueError("all trackers must be on one device")
        self.cfg = first.cfg
        self.sensor = first.sensor
        self.device = first.device
        for i, tr in enumerate(self.trackers):
            tr.session = i
        # batched steps run, and sequence-steps they carried (for the rate)
        self.steps = 0
        self.batched_frames = 0

    def process(self, frames, timestamps):
        """``frames``: per sequence (gray, depth), or (left, right) for
        stereo trackers; ``timestamps``: per sequence. Returns each
        sequence's result of ``Tracker.process`` (the previous frame's pose,
        or None).

        Trackers in OK state with a local map take one batched step; the
        others step solo through ``Tracker.process``."""
        batch = [i for i, tr in enumerate(self.trackers)
                 if tr.state == T.OK and tr._lm_args is not None]
        # every tracker counts one frame a step: the span's frame ids are
        # theirs once counted
        with tracing.span("multi.step", step=self.steps, batched=len(batch),
                          frame=[tr.frame_id + 1 for tr in self.trackers]):
            results = [None] * len(self.trackers)
            for i, (tr, (g, d)) in enumerate(zip(self.trackers, frames)):
                if i not in batch:
                    results[i] = tr.process(g, d, timestamps[i])
            if not batch:
                return results
            grays, depths, args = [], [], []
            for i in batch:
                tr = self.trackers[i]
                tr.begin_frame()
                gq, dq = tr._quantize_inputs(*frames[i])
                grays.append(gq)
                depths.append(dq if self.sensor == "stereo" else dq.astype(np.int32))
                args.append(tr.dispatch_args())
            with tracing.span("sync.upload"):
                gray = torch.from_numpy(np.stack(grays)).to(self.device)
                depth = torch.from_numpy(np.stack(depths)).to(self.device)
            out = batched_step(self.cfg, gray, depth, stack_args(args),
                               stereo=self.sensor == "stereo")
            record = T.BatchRecord(out)
            for b, i in enumerate(batch):
                results[i] = self.trackers[i].process(
                    None, None, timestamps[i], precomputed_out=slice_out(out, b),
                    host_record=functools.partial(record.row, b))
            self.steps += 1
            self.batched_frames += len(batch)
            return results

    def flush(self):
        """Drain every tracker's in-flight frames."""
        for tr in self.trackers:
            tr.flush()
