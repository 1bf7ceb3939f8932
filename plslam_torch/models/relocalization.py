"""Relocalization: recover the pose after tracking loss.

The reference protocol (Tracking::Relocalization, Tracking.cc:2049-2269):
BoW candidates from the keyframe database, then per candidate a descriptor
match against the keyframe's map points, EPnP RANSAC and pose
optimization. The counterpart of ``models/relocalization.py`` in the JAX
package:

- the candidate match is one dense ratio-test Hamming top-2 (1024 x 1024
  with the gate ``kp_valid x has_point``: the CUDA kernel on the card) with
  the rotation histogram and a one-to-one dedupe;
- RGB-D gives every current keypoint with depth a 3D position, so the
  minimal solver is a batched 3-point Kabsch RANSAC (``optim/horn.py``) on
  3D-3D pairs; EPnP over every match (``optim/epnp.py``) takes over when
  fewer than 12 pairs agree;
- the pose LM (``optim/pose.py``) refines on the 3D-2D matches, and the
  first of at most 5 candidates with >= 50 inliers is accepted
  (Tracking.cc:2240-2260).

RANSAC draws come from a ``torch.Generator`` on the map's device seeded
from (frame id, candidate), or are injected to reproduce another
implementation's draws. EPnP is only computed when Horn has < 12 inliers;
it draws after Horn, so Horn's result does not depend on it.

While the recorder of utils.tracing is on, a relocalization is a ``reloc``
span with its query (``reloc.query``) and each candidate try
(``reloc.candidate``) under it, and counts ``reloc.tries`` and
``reloc.candidates``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..bow.vocabulary import sparse_bow
from ..config import SlamConfig
from ..geometry import projection as gproj
from ..ops import matching
from ..optim import epnp, horn
from ..optim import pose as pose_opt
from ..utils import tracing
from .frame import FrameData

RELOC_ACCEPT_INLIERS = 50
EPNP_BELOW = 12  # Horn inliers under which EPnP's pose is taken


def reloc_match(cfg: SlamConfig, fd: FrameData, kf_desc, kf_angle, kf_has_pt):
    """Dense ratio-test match of every valid current feature against the
    candidate's features that hold a map point. Depthless features still
    vote through the EPnP branch (the reference's solver is 3D-2D EPnP
    throughout, Tracking.cc:2105-2131); the rotation histogram is on, as
    the reference's SearchByBoW runs with mbCheckOrientation
    (ORBmatcher.cc:247-421 via Tracking.cc:2090)."""
    gate = fd.kp_valid[:, None] & kf_has_pt[None, :]
    return matching.match_descriptors(
        fd.kp_desc, kf_desc, gate, 100, nn_ratio=cfg.matcher.nn_ratio_reloc,
        angle_q=fd.kp_angle, angle_t=kf_angle, dedupe=True)


def reloc_solve(cfg: SlamConfig, fd: FrameData, m: matching.MatchResult, kf_pt_w,
                generator=None, horn_samples=None, epnp_samples=None):
    """Pose (R, t) world->camera from the matches: Horn RANSAC on the
    depth-paired matches, EPnP over every match when Horn has fewer than
    ``EPNP_BELOW`` inliers. Returns (R, t, the matched world points)."""
    cam = cfg.camera
    tgt = m.idx.long().clamp(0, kf_pt_w.shape[0] - 1)
    src_cam = gproj.backproject(cam, fd.kp_xy_un, fd.kp_depth)  # current camera
    dst_w = kf_pt_w[tgt]                                        # world
    ok_d = m.ok & (fd.kp_depth > 0)
    _, R_wc, t_wc, _, n_inl = horn.ransac_align(
        src_cam, dst_w, ok_d, generator, thresh=0.07, n_hyp=256, with_scale=False,
        samples=horn_samples)
    # x_c = R x_w + t with R = R_wc^T, t = -R_wc^T t_wc
    R0, t0 = R_wc.T, -(R_wc.T @ t_wc)
    if int(n_inl) < EPNP_BELOW:
        # the depth-paired matches starve the 3D-3D solver (shallow scenes,
        # depth dropouts): 3D-2D over every match
        R0, t0, _, _ = epnp.ransac_epnp(cam, dst_w, fd.kp_xy_un, m.ok, generator,
                                        samples=epnp_samples)
    return R0, t0, dst_w


def reloc_refine(cfg: SlamConfig, fd: FrameData, m: matching.MatchResult, dst_w, R0, t0):
    """Pose LM on the matched 3D-2D observations (no lines)."""
    dev = dst_w.device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    obs = pose_opt.PoseObs(
        p3d=dst_w, uv=fd.kp_xy_un,
        u_right=torch.where(m.ok, fd.kp_ur, torch.full_like(fd.kp_ur, -1.0)),
        inv_sigma2=(1.0 / cfg.orb.scale_factor**2) ** fd.kp_octave.float(),
        valid=m.ok,
        line_nw=z(1, 3), line_vw=z(1, 3), line_uv=z(1, 2, 2),
        line_inv_sigma2=torch.ones(1, dtype=torch.float32, device=dev),
        line_valid=torch.zeros(1, dtype=torch.bool, device=dev))
    return pose_opt.optimize_pose(cfg.camera, R0, t0, obs)


def reloc_candidate_step(cfg: SlamConfig, fd: FrameData,
                         kf_desc: torch.Tensor,    # (N, 32) candidate's descriptors
                         kf_angle: torch.Tensor,   # (N,) its keypoint angles (degrees)
                         kf_has_pt: torch.Tensor,  # (N,) feature holds a valid map point
                         kf_pt_w: torch.Tensor,    # (N, 3) world position of that point
                         generator: torch.Generator | None = None,
                         horn_samples: torch.Tensor | None = None,
                         epnp_samples: torch.Tensor | None = None):
    """Match the current frame against one candidate keyframe, Horn RANSAC
    (EPnP fallback), pose LM. Returns (R, t, matched candidate feature per
    current feature, inlier mask, n_inliers)."""
    m = reloc_match(cfg, fd, kf_desc, kf_angle, kf_has_pt)
    R0, t0, dst_w = reloc_solve(cfg, fd, m, kf_pt_w, generator, horn_samples, epnp_samples)
    res = reloc_refine(cfg, fd, m, dst_w, R0, t0)
    return res.R, res.t, m.idx, m.ok & res.inlier_pts, res.n_inliers


def candidate_inputs(slam_map, kf: int):
    """(has_pt (N,) bool, world points (N, 3)) of keyframe ``kf`` on the
    map's device: which of its features hold a valid map point, and where.
    Caller holds the map lock."""
    m = slam_map
    pids = m.kf_pt_idx[kf]
    has = (pids >= 0) & m.pt_valid[np.clip(pids, 0, None)] & m.kf_frames[kf].kp_valid
    ptw = np.zeros((len(pids), 3), np.float32)
    ptw[has] = m.pt_pos[pids[has]]
    return (torch.as_tensor(has, device=m.device), torch.as_tensor(ptw, device=m.device))


def reloc_generator(device, frame_id: int, candidate: int) -> torch.Generator:
    """The RANSAC draws of one candidate try: seeded from (frame, candidate)."""
    g = torch.Generator(device=device)
    g.manual_seed(frame_id * 16 + candidate)
    return g


def try_relocalize(tracker, fd: FrameData):
    """On the host: query the database, try at most 5 candidates, accept by
    the reference's inlier bar. Returns (R, t, map point id per current
    feature) as numpy, or None. Holds the map lock: a mapper thread may
    cull keyframes."""
    if tracker.kfdb is None or tracker.voc is None:
        return None
    m = tracker.map
    tracing.count("reloc.tries")
    with tracing.span("reloc"), contextlib.ExitStack() as held:
        with tracing.span("reloc.query"):
            _, bow = tracker.voc.transform(fd.kp_desc, fd.kp_valid)
            bow = sparse_bow(bow)
            held.enter_context(tracing.locked(tracker._map_lock))
            cands = tracker.kfdb.detect_reloc_candidates(bow, m)
        for ci, kf in enumerate(cands[:5]):
            tracing.count("reloc.candidates")
            with tracing.span("reloc.candidate", kf=int(kf)) as sp:
                has, ptw = candidate_inputs(m, kf)
                dkf = m.device_frame(kf)  # descriptors and angles stay on the device
                R, t, idx, inl, n = reloc_candidate_step(
                    tracker.cfg, fd, dkf.kp_desc, dkf.kp_angle, has, ptw,
                    reloc_generator(m.device, tracker.frame_id, ci))
                n = int(n)
                sp.set(n_inliers=n)
            if n >= RELOC_ACCEPT_INLIERS:
                R, t, idx, inl = (x.cpu().numpy() for x in (R, t, idx, inl))
                pids = m.kf_pt_idx[kf]
                cur_pt_ids = np.full(len(pids), -1, np.int32)
                sel = np.nonzero(inl)[0]
                cur_pt_ids[sel] = pids[idx[sel]]
                return R, t, cur_pt_ids
    return None
