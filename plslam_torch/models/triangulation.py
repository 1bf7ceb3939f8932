"""Epipolar triangulation of new map points and lines between keyframe
pairs, the port of the JAX package's ``models/triangulation.py``.

``LocalMapping::CreateNewMapPoints`` (LocalMapping.cc:346-667): for the new
keyframe and each of its best covisible neighbours, match features that
still lack a landmark under an epipolar gate (SearchForTriangulation +
CheckDistEpipolarLine, ORBmatcher.cc:884-1100) with the gated Hamming
kernel, DLT-triangulate every match in one batched SVD, and keep those that
pass the reference's acceptance ladder (parallax, cheirality and
reprojection chi2 in both views, scale-distance band, :558-650).
``CreateNewMapLines`` (:668-916) does the same for lines with LBD matching
and two (NL, 4, 4) SVDs, one per endpoint.

RGB-D: depth-seeded creation (models.tracking) covers what the sensor
reaches; the point pass takes only features with no valid depth.

The null vector of a DLT system is defined up to sign, and LAPACK and
cuSOLVER may return either; dehomogenising removes the sign. A
rank-deficient system has no unique null vector, so runs on different
devices can accept slightly different sets.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import lbd as lbd_mod
from ..ops import matching

EPI_CHI2 = 3.84      # 1-dof epipolar distance gate (ORBmatcher.cc:1022)
REPROJ_CHI2 = 5.991  # 2-dof reprojection gate (LocalMapping.cc:594,612)
MIN_PARALLAX_COS = 0.9998  # LocalMapping.cc:523
# LBD gate for line triangulation matching, normalized squared L2 over the
# quantized descriptor (the reference uses a MAD-adaptive Hamming threshold,
# KeyFrame.cc:773-798)
LINE_DESC_TH = 0.6
LINE_ANGLE_TH = 15.0 * np.pi / 180.0


def _kmat(cam, device):
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def _center(R, t):
    return -(R.T @ t)


def fundamental_from_poses(cam, R1, t1, R2, t2):
    """F12 with x2^T F12 x1 = 0 (pixel coordinates), cameras world->cam
    (LocalMapping::ComputeF12, LocalMapping.cc:1106-1126)."""
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    z = torch.zeros((), dtype=t21.dtype, device=t21.device)
    tx = torch.stack([torch.stack([z, -t21[2], t21[1]]),
                      torch.stack([t21[2], z, -t21[0]]),
                      torch.stack([-t21[1], t21[0], z])])
    Kinv = torch.linalg.inv(_kmat(cam, R1.device))
    return Kinv.T @ tx @ R21 @ Kinv


def _dlt(A):
    """Dehomogenised null vector of each (N, 4, 4) system."""
    Xh = torch.linalg.svd(A).Vh[:, 3, :]
    w = Xh[:, 3]
    return Xh[:, :3] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))[:, None]


def epipolar_gate(cfg: SlamConfig, xy1, oct1, cand1, R1, t1, xy2, oct2, cand2, R2, t2):
    """(N, M) gate of a keyframe pair's match: keypoint 2 within the
    epipolar chi2 band of keypoint 1 (in pixels, at keypoint 2's scale),
    octaves within one level, both candidates."""
    scale = cfg.orb.scale_factor
    dev = xy1.device
    F12 = fundamental_from_poses(cfg.camera, R1, t1, R2, t2)
    h1 = torch.cat([xy1, torch.ones((xy1.shape[0], 1), device=dev)], -1)  # (N, 3)
    h2 = torch.cat([xy2, torch.ones((xy2.shape[0], 1), device=dev)], -1)
    lines2 = h1 @ F12.T             # epipolar line of each kp1 in image 2
    num = lines2 @ h2.T             # (N, M) signed distances * norm
    den = lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2
    dsq = num * num / den.clamp(min=1e-9)
    sigma2_2 = scale ** (2.0 * oct2.float())
    epi_ok = dsq <= EPI_CHI2 * sigma2_2[None, :]
    return epi_ok & cand1[:, None] & cand2[None, :] & matching.octave_gate(oct1, oct2, -1, 1)


def triangulate_pair_step(cfg: SlamConfig, xy1, oct1, desc1, cand1, R1, t1,
                          xy2, oct2, desc2, cand2, R2, t2):
    """Match and triangulate one keyframe pair (keyframe 1 is the new one;
    ``cand`` = valid, without depth, unbound). Returns (pw (N,3), idx2 (N,),
    ok (N,)) indexed by keyframe 1's features."""
    cam = cfg.camera
    scale = cfg.orb.scale_factor
    dev = xy1.device
    gate = epipolar_gate(cfg, xy1, oct1, cand1, R1, t1, xy2, oct2, cand2, R2, t2)
    m = matching.match_descriptors(desc1, desc2, gate, 50, dedupe=True)
    idx2 = m.idx.long().clamp(0, xy2.shape[0] - 1)

    # --- batched DLT -----------------------------------------------------
    K = _kmat(cam, dev)
    P1 = K @ torch.cat([R1, t1[:, None]], -1)  # (3, 4)
    P2 = K @ torch.cat([R2, t2[:, None]], -1)
    uv1 = xy1
    uv2 = xy2[idx2]
    A = torch.stack([uv1[:, 0:1] * P1[2] - P1[0], uv1[:, 1:2] * P1[2] - P1[1],
                     uv2[:, 0:1] * P2[2] - P2[0], uv2[:, 1:2] * P2[2] - P2[1]], 1)
    pw = _dlt(A)

    # --- acceptance ladder -------------------------------------------------
    r1 = pw - _center(R1, t1)
    r2 = pw - _center(R2, t2)
    d1 = torch.linalg.vector_norm(r1, dim=-1)
    d2 = torch.linalg.vector_norm(r2, dim=-1)
    cos_par = (r1 * r2).sum(-1) / (d1 * d2).clamp(min=1e-9)

    def reproj_chi2(R, t, uv, octv):
        pc = pw @ R.T + t
        z = torch.where(pc[:, 2].abs() > 1e-6, pc[:, 2], torch.full_like(pc[:, 2], 1e-6))
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        err = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return err * (1.0 / scale**2) ** octv.float(), pc[:, 2]

    chi_1, z1 = reproj_chi2(R1, t1, uv1, oct1)
    chi_2, z2 = reproj_chi2(R2, t2, uv2, oct2[idx2])
    # scale-consistency band (LocalMapping.cc:637-650)
    ratio = d1 / d2.clamp(min=1e-9)
    ratio_oct = scale ** oct1.float() / scale ** oct2[idx2].float()
    rf = scale * 1.5
    scale_ok = (ratio < ratio_oct * rf) & (ratio > ratio_oct / rf)
    ok = (m.ok & (cos_par < MIN_PARALLAX_COS) & (cos_par > 0) & (z1 > 0.05) & (z2 > 0.05)
          & (chi_1 <= REPROJ_CHI2) & (chi_2 <= REPROJ_CHI2) & scale_ok)
    return pw, idx2, ok


class Triangulator:
    """Host driver over the new keyframe's covisible neighbourhood."""

    def __init__(self, cfg: SlamConfig, slam_map):
        self.cfg = cfg
        self.map = slam_map

    def create_new_points(self, kf: int, mapper=None, lock=None) -> int:
        """Triangulate beyond-depth points of a new keyframe against its best
        covisible neighbours; returns the number created. ``lock`` is held
        around snapshots and map mutation, not around device work."""
        m = self.map
        lock = lock or contextlib.nullcontext()
        dev = m.device
        with lock:
            neighbors = m.covisible_keyframes(kf, self.cfg.mapping.triangulation_neighbors)
            if not neighbors:
                return 0
            host1 = m.kf_frames[kf]
            cand1_np = host1.kp_valid & ~(host1.kp_depth > 0) & (m.kf_pt_idx[kf] < 0)
            if not cand1_np.any():
                return 0
            R1, t1 = m.kf_R[kf].copy(), m.kf_t[kf].copy()
        fd1 = m.device_frame(kf)
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        created = 0
        for okf in neighbors:
            if created >= 256:
                break
            with lock:
                host2 = m.kf_frames[okf]
                if host2 is None:
                    continue
                cand2_np = host2.kp_valid & (m.kf_pt_idx[okf] < 0)
                R2, t2 = m.kf_R[okf].copy(), m.kf_t[okf].copy()
                fd2 = m.device_frame(okf)
            if not cand2_np.any():
                continue
            pw, idx2, ok = triangulate_pair_step(
                self.cfg, fd1.kp_xy_un, fd1.kp_octave, fd1.kp_desc, up(cand1_np),
                up(R1), up(t1), fd2.kp_xy_un, fd2.kp_octave, fd2.kp_desc, up(cand2_np),
                up(R2), up(t2))
            pw, idx2, ok = pw.cpu().numpy(), idx2.cpu().numpy(), ok.cpu().numpy()
            feats = np.nonzero(ok)[0]
            if len(feats) == 0:
                continue
            c1 = -R1.T @ t1
            new_feats, new_pids = [], []
            with lock:
                if not (m.kf_valid[kf] and m.kf_valid[okf]):
                    break
                for f in feats:
                    if m.kf_pt_idx[kf, f] >= 0:
                        continue  # a previous neighbour already bound it
                    f2 = int(idx2[f])
                    if m.kf_pt_idx[okf, f2] >= 0:
                        continue
                    p = pw[f]
                    dist = float(np.linalg.norm(p - c1))
                    level = int(host1.kp_octave[f])
                    max_d = dist * self.cfg.orb.scale_factor ** level
                    min_d = max_d / self.cfg.orb.scale_factor ** (self.cfg.orb.n_levels - 1)
                    normal = (p - c1) / max(dist, 1e-6)
                    pid = m.add_point(p, None, normal, min_d, max_d, kf)
                    m.add_point_obs(pid, kf, int(f))
                    m.add_point_obs(pid, okf, f2)
                    new_feats.append(int(f))
                    new_pids.append(pid)
                    cand1_np[f] = False
                    created += 1
                if new_pids:
                    m.scatter_point_descs_from(fd1.kp_desc, np.array(new_feats, np.int32),
                                               np.array(new_pids, np.int32))
            if new_pids and mapper is not None:
                mapper.on_new_landmarks(kf, np.array(new_pids, np.int32), np.zeros(0, np.int32))
        return created


def triangulate_lines_pair_step(cfg: SlamConfig, ep1, coeff1, angle1, desc1, cand1, R1, t1,
                                ep2, coeff2, angle2, desc2, cand2, R2, t2, median_depth2):
    """CreateNewMapLines for one keyframe pair: match lines (LBD and an
    angle gate), then triangulate each endpoint of line 1 from the two
    back-projected line planes (coeff^T K [R|t]) and the endpoint's own ray
    rows, one (NL, 4, 4) SVD per endpoint. Acceptance: scene-median-depth
    ratios and cheirality in both views (LocalMapping.cc:816-900)."""
    cam = cfg.camera
    dev = ep1.device
    # flip-invariant quantized L2, scaled into the shared matcher's range
    dist = lbd_mod.lbd_distance_matrix(desc1, desc2) // 256
    th = int(lbd_mod.quantize_distance_threshold(LINE_DESC_TH) // 256)
    da = (angle1[:, None] - angle2[None, :]).abs()
    da = torch.minimum(da, np.pi - da)
    gate = cand1[:, None] & cand2[None, :] & (da < LINE_ANGLE_TH)
    m = matching.best_matches(dist, gate, max_dist=th, nn_ratio=0.9)
    m = matching.dedupe_targets(m, ep2.shape[0])
    idx2 = m.idx.long().clamp(0, ep2.shape[0] - 1)

    K = _kmat(cam, dev)
    T1 = torch.cat([R1, t1[:, None]], -1)  # (3, 4)
    row_l1 = coeff1 @ (K @ T1)              # (NL, 4)
    row_l2 = coeff2[idx2] @ (K @ torch.cat([R2, t2[:, None]], -1))
    pts = []
    for k in (0, 1):
        x = (ep1[:, k, 0] - cam.cx) / cam.fx
        y = (ep1[:, k, 1] - cam.cy) / cam.fy
        r0 = x[:, None] * T1[2] - T1[0]
        r1 = y[:, None] * T1[2] - T1[1]
        pts.append(_dlt(torch.stack([row_l1, row_l2, r0, r1], 1)))
    s3d, e3d = pts
    md = median_depth2.clamp(min=1e-6)
    ratio1 = torch.linalg.vector_norm(s3d - _center(R1, t1), dim=-1) / md
    ratio2 = torch.linalg.vector_norm(s3d - _center(R2, t2), dim=-1) / md
    ratio3 = torch.linalg.vector_norm(e3d - s3d, dim=-1) / md

    def z_in(R, t, p):
        return p @ R[2] + t[2]

    ok = (m.ok & (ratio1 >= 0.3) & (ratio2 >= 0.3) & (ratio3 <= 1.0)
          & (z_in(R1, t1, s3d) > 0) & (z_in(R2, t2, s3d) > 0)
          & (z_in(R1, t1, e3d) > 0) & (z_in(R2, t2, e3d) > 0))
    return torch.stack([s3d, e3d], 1), idx2, ok


def scene_median_depth(m, kf: int) -> float:
    """KeyFrame::ComputeSceneMedianDepth(2): median z of the keyframe's
    observed map points in its camera frame."""
    pids = m.kf_pt_idx[kf]
    pids = pids[pids >= 0]
    pids = pids[m.pt_valid[pids]]
    if len(pids) == 0:
        return 0.0
    z = m.pt_pos[pids] @ m.kf_R[kf][2] + m.kf_t[kf][2]
    return float(np.median(z))


def create_new_lines(cfg, m, kf: int, mapper=None, lock=None) -> int:
    """CreateNewMapLines host driver (LocalMapping.cc:668-916): triangulate
    unbound lines of the new keyframe against its covisible neighbours,
    skipping neighbours closer than 1% of the scene depth. ``lock`` is held
    around snapshots and map mutation, not around device work."""
    lock = lock or contextlib.nullcontext()
    dev = m.device
    with lock:
        neighbors = m.covisible_keyframes(kf, cfg.mapping.triangulation_neighbors)
        if not neighbors:
            return 0
        host1 = m.kf_frames[kf]
        if host1 is None or not host1.ln_valid.any():
            return 0
        cand1_np = host1.ln_valid & (m.kf_ln_idx[kf] < 0)
        if not cand1_np.any():
            return 0
        R1, t1 = m.kf_R[kf].copy(), m.kf_t[kf].copy()
    fd1 = m.device_frame(kf)
    c1 = -R1.T @ t1
    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    created = 0
    for okf in neighbors:
        if created >= 64:
            break
        with lock:
            host2 = m.kf_frames[okf]
            if host2 is None or not host2.ln_valid.any():
                continue
            md2 = scene_median_depth(m, okf)
            baseline = float(np.linalg.norm(m.kf_camera_center(okf) - c1))
            if md2 <= 0 or baseline / md2 < 0.01:
                continue
            cand2_np = host2.ln_valid & (m.kf_ln_idx[okf] < 0)
            R2, t2 = m.kf_R[okf].copy(), m.kf_t[okf].copy()
            fd2 = m.device_frame(okf)
        if not cand2_np.any():
            continue
        ep_w, idx2, ok = triangulate_lines_pair_step(
            cfg, fd1.ln_ep_un, fd1.ln_coeff, fd1.ln_angle, fd1.ln_desc, up(cand1_np),
            up(R1), up(t1), fd2.ln_ep_un, fd2.ln_coeff, fd2.ln_angle, fd2.ln_desc,
            up(cand2_np), up(R2), up(t2),
            torch.tensor(md2, dtype=torch.float32, device=dev))
        ep_w, idx2, ok = ep_w.cpu().numpy(), idx2.cpu().numpy(), ok.cpu().numpy()
        feats = np.nonzero(ok)[0]
        if len(feats) == 0:
            continue
        new_feats, new_lids = [], []
        with lock:
            if not (m.kf_valid[kf] and m.kf_valid[okf]):
                break
            for f in feats:
                if m.kf_ln_idx[kf, f] >= 0:
                    continue
                f2 = int(idx2[f])
                if m.kf_ln_idx[okf, f2] >= 0:
                    continue
                lid = m.add_line(ep_w[f], None, kf)
                m.add_line_obs(lid, kf, int(f))
                m.add_line_obs(lid, okf, f2)
                new_feats.append(int(f))
                new_lids.append(lid)
                cand1_np[f] = False
                created += 1
            if new_lids:
                m.scatter_line_descs_from(fd1.ln_desc, np.array(new_feats, np.int32),
                                          np.array(new_lids, np.int32))
        if new_lids and mapper is not None:
            mapper.on_new_landmarks(kf, np.zeros(0, np.int32), np.array(new_lids, np.int32))
    return created
