"""Distinctive landmark descriptors: the minimum-median Hamming winner over
a landmark's observations, the port of the JAX package's ``models/distinctive.py``.

``MapPoint::ComputeDistinctiveDescriptors`` (MapPoint.cc: every observing
keyframe's descriptor, all pairwise distances, keep the one with the
smallest median distance to the rest), for a whole batch of landmarks
after the fusion pass:

- the observing keyframes' descriptor tables are the device FrameData
  tensors (``SlamMap.device_frame``), stacked on the device;
- the (P, O, O) pairwise distances are a plain product of unpacked bits
  (LBD's flip-invariant squared L2 for lines);
- a masked median (sort with padding at the tail, gather at
  (n - 1) // 2) and a first-index argmin pick the winner, which is copied
  into the device descriptor arena in place: descriptors never reach the
  host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming
from ..ops import lbd as lbd_mod

MAX_OBS = 8  # observations considered per landmark (newest kept)


def _min_median_winner(d: torch.Tensor, dist: torch.Tensor, obs_valid: torch.Tensor,
                       big: int) -> torch.Tensor:
    """Row of ``d`` (P, O, D) with the smallest median distance to the
    landmark's other valid observations; ties go to the first."""
    O = d.shape[1]
    pair_ok = obs_valid[:, :, None] & obs_valid[:, None, :]
    dist = torch.where(pair_ok, dist, torch.full_like(dist, big))
    srt = torch.sort(dist, dim=-1).values                      # (P, O, O)
    nv = obs_valid.sum(-1, dtype=torch.int64)                  # (P,)
    mid = ((nv - 1).div(2, rounding_mode="floor")).clamp(0, O - 1)
    med = torch.gather(srt, 2, mid[:, None, None].expand(-1, O, 1))[..., 0]
    med = torch.where(obs_valid, med, torch.full_like(med, big))
    best = torch.argmin(med, dim=-1)                           # first minimum
    return torch.gather(d, 1, best[:, None, None].expand(-1, 1, d.shape[-1]))[:, 0]


def _distinctive_core(stacked_desc, kf_slot, feat_idx, obs_valid):
    """stacked_desc (K, N, 32) u8; kf_slot / feat_idx (P, O) int64;
    obs_valid (P, O) bool -> (P, 32) winning descriptor rows."""
    d = stacked_desc[kf_slot, feat_idx]                        # (P, O, 32)
    P, O, _ = d.shape
    bits = hamming.unpack_bits(d.reshape(P * O, 32)).reshape(P, O, 256).float()
    g = bits @ bits.mT                                         # exact: TF32 is off
    n = bits.sum(-1)
    dist = (n[:, :, None] + n[:, None, :] - 2.0 * g).to(torch.int32)
    return _min_median_winner(d, dist, obs_valid, 1 << 20)


def _line_distinctive_core(stacked_desc, kf_slot, feat_idx, obs_valid):
    """Line analog of :func:`_distinctive_core` over quantized LBD
    (K, NL, 72), with the flip-invariant squared L2 the line matcher uses
    (MapLine::ComputeDistinctiveDescriptors, MapLine.cpp:269)."""
    d = stacked_desc[kf_slot, feat_idx]                        # (P, O, 72)
    return _min_median_winner(d, lbd_mod.lbd_distance_matrix(d, d), obs_valid, 1 << 30)


def _gather_obs(m, ids, obs_of, cap):
    """Per landmark its newest ``MAX_OBS`` observations as (slot, feat,
    valid) tables over the set of observing keyframes; None when that set
    is empty or larger than 24 (the JAX package's fixed K)."""
    ids = ids[:cap]
    kfs: list[int] = []
    kf_slot_of: dict[int, int] = {}
    rows = np.zeros((len(ids), MAX_OBS), np.int64)
    feats = np.zeros((len(ids), MAX_OBS), np.int64)
    valid = np.zeros((len(ids), MAX_OBS), bool)
    for i, lid in enumerate(ids):
        for o, (kf, feat) in enumerate(sorted(obs_of[lid].items())[-MAX_OBS:]):
            if m.kf_frames_dev[kf] is None and m.kf_frames[kf] is None:
                continue
            s = kf_slot_of.get(kf)
            if s is None:
                s = kf_slot_of[kf] = len(kfs)
                kfs.append(kf)
            rows[i, o] = s
            feats[i, o] = feat
            valid[i, o] = True
    if not kfs or len(kfs) > 24:
        return None
    dev = m.device
    return (ids, kfs, torch.as_tensor(rows, device=dev), torch.as_tensor(feats, device=dev),
            torch.as_tensor(valid, device=dev))


def refresh_line_descriptors(m, lids) -> int:
    """MapLine::ComputeDistinctiveDescriptors + UpdateAverageDir
    (MapLine.cpp:269, 427) over a batch of line ids (at most 256): the
    winners go into the device line arena, and the host viewing stats are
    refreshed. Returns the count."""
    lids = [int(l) for l in lids if m.ln_valid[l] and len(m.ln_obs[l]) >= 2]
    if not lids:
        return 0
    got = _gather_obs(m, lids, m.ln_obs, 256)
    if got is None:
        return 0
    lids, kfs, rows, feats, valid = got
    stacked = torch.stack([m.device_frame(k).ln_desc for k in kfs])
    m.scatter_line_desc_rows(lids, _line_distinctive_core(stacked, rows, feats, valid))
    update_line_stats(m, lids)
    return len(lids)


def update_line_stats(m, lids):
    """UpdateAverageDir (MapLine.cpp:427): mean viewing direction of the
    line midpoint over observing keyframes and a distance band around the
    mean observation distance. Host numpy."""
    for lid in lids:
        obs = m.ln_obs[lid]
        if not obs or not m.ln_valid[lid]:
            continue
        mid = 0.5 * (m.ln_ep[lid, 0] + m.ln_ep[lid, 1])
        dirs = []
        dists = []
        for kf in obs:
            if not m.kf_valid[kf]:
                continue
            v = mid - m.kf_camera_center(kf)
            d = float(np.linalg.norm(v))
            if d > 1e-6:
                dirs.append(v / d)
                dists.append(d)
        if not dirs:
            continue
        n = np.mean(dirs, axis=0)
        nn = float(np.linalg.norm(n))
        if nn > 1e-6:
            m.ln_normal[lid] = n / nn
        dm = float(np.mean(dists))
        m.ln_max_dist[lid] = 1.6 * dm
        m.ln_min_dist[lid] = dm / 1.6


def refresh_distinctive_descriptors(m, pids) -> int:
    """Recompute the descriptors of the given landmark ids (at most 512)
    from their current observations into the device arena. Returns the
    count."""
    pids = [int(p) for p in pids if m.pt_valid[p] and len(m.pt_obs[p]) >= 2]
    if not pids:
        return 0
    got = _gather_obs(m, pids, m.pt_obs, 512)
    if got is None:
        return 0  # degenerate or oversized batch: skip this round
    pids, kfs, rows, feats, valid = got
    stacked = torch.stack([m.device_frame(k).kp_desc for k in kfs])
    m.scatter_point_desc_rows(pids, _distinctive_core(stacked, rows, feats, valid))
    return len(pids)
