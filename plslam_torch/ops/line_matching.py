"""Line association: project map lines, clip, gate, match.

The reference's ``LineMatcher`` (LineMatcher.cpp) iterates map lines one by
one (visibility cases :125-179, Liang–Barsky clip :1389-1460, then an
all-pairs gate cascade: descriptor distance → angle → length ratio →
axis-projection overlap :1508-1559 → endpoint-to-line reprojection error
:1579-1596, with a relaxed retry when fewer than 20% of frame lines matched
:235-261). Here the whole thing is a fixed-shape (N_map, N_frame) gate
matrix + masked argmin; the relaxed retry is computed branchlessly and
selected by match count.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import LineConfig
from ..geometry import lines as glines
from ..geometry import se3
from . import lbd as lbd_mod
from . import matching


class ProjectedLines(NamedTuple):
    uv: torch.Tensor      # (N, 2, 2) clipped projected endpoints
    coeff: torch.Tensor   # (N, 3) projected infinite line (normalized)
    angle: torch.Tensor   # (N,) radians of projected direction
    length: torch.Tensor  # (N,)
    ok: torch.Tensor      # (N,) bool


def project_lines(
    cam, R: torch.Tensor, t: torch.Tensor, ep_w: torch.Tensor, valid: torch.Tensor,
    z_near: float = 0.05,
) -> ProjectedLines:
    """Project world-space 3D segments (N, 2, 3) into the image.

    Reference visibility cases (LineMatcher.cpp:125-179): both endpoints
    behind → drop; one behind → clip the 3D segment at z = z_near; then
    project and Liang–Barsky clip to the image rectangle.
    """
    p0 = se3.apply(R, t, ep_w[:, 0])  # (N, 3) camera frame
    p1 = se3.apply(R, t, ep_w[:, 1])
    z0, z1 = p0[:, 2], p1[:, 2]
    both_behind = (z0 < z_near) & (z1 < z_near)
    # clip the segment against the z = z_near plane
    denom = z1 - z0
    s = (z_near - z0) / torch.where(denom.abs() > 1e-9, denom, torch.full_like(denom, 1e-9))
    s = s.clamp(0.0, 1.0)
    cut = p0 + s[:, None] * (p1 - p0)
    p0c = torch.where((z0 < z_near)[:, None], cut, p0)
    p1c = torch.where((z1 < z_near)[:, None], cut, p1)

    def proj(p):
        z = p[:, 2].clamp(min=1e-6)
        return torch.stack(
            [cam.fx * p[:, 0] / z + cam.cx, cam.fy * p[:, 1] / z + cam.cy], -1
        )

    uv0 = proj(p0c)
    uv1 = proj(p1c)
    q0, q1, in_img = glines.liang_barsky(
        uv0, uv1, 0.0, 0.0, float(cam.width - 1), float(cam.height - 1)
    )
    d = q1 - q0
    length = torch.sqrt((d**2).sum(-1))
    ok = valid & ~both_behind & in_img & (length > 1.0)
    coeff = glines.line_equation_2d(q0, q1)
    angle = torch.atan2(d[:, 1], d[:, 0])
    return ProjectedLines(torch.stack([q0, q1], 1), coeff, angle, length, ok)


def _angle_diff(a, b):
    """Direction-invariant angular difference between LINE directions
    (mod pi): a segment and its endpoint-swapped twin are the same line."""
    d = torch.remainder((a[:, None] - b[None, :]).abs(), math.pi)
    return torch.minimum(d, math.pi - d)


def _axis_overlap(ep_a: torch.Tensor, ep_b: torch.Tensor, angle_a: torch.Tensor):
    """Overlap ratio along the dominant axis of line a (LineOverLap,
    LineMatcher.cpp:1508-1559). ep_*: (N,2,2), (M,2,2)."""
    use_x = (torch.cos(angle_a).abs() >= torch.sin(angle_a).abs())[:, None]
    a0 = torch.where(use_x, ep_a[:, 0, 0:1], ep_a[:, 0, 1:2])  # (N,1)
    a1 = torch.where(use_x, ep_a[:, 1, 0:1], ep_a[:, 1, 1:2])
    b0 = torch.where(use_x, ep_b[None, :, 0, 0], ep_b[None, :, 0, 1])  # (N,M)
    b1 = torch.where(use_x, ep_b[None, :, 1, 0], ep_b[None, :, 1, 1])
    return glines.segment_overlap(a0, a1, b0, b1)


def _gate_and_match(proj: ProjectedLines, f_ep, f_angle, f_length, f_valid,
                    dist, angle_th, len_ratio_th, overlap_th, desc_th,
                    reproj_th) -> matching.MatchResult:
    d_ang = _angle_diff(proj.angle, f_angle)
    len_ratio = torch.minimum(proj.length[:, None], f_length[None, :]) / torch.maximum(
        proj.length[:, None], f_length[None, :]).clamp(min=1e-6)
    ov = _axis_overlap(proj.uv, f_ep, proj.angle)
    # endpoint-to-projected-line distances (ReprojectionError semantics)
    c = proj.coeff
    d0 = (c[:, None, 0] * f_ep[None, :, 0, 0] + c[:, None, 1] * f_ep[None, :, 0, 1]
          + c[:, None, 2]).abs()
    d1 = (c[:, None, 0] * f_ep[None, :, 1, 0] + c[:, None, 1] * f_ep[None, :, 1, 1]
          + c[:, None, 2]).abs()
    reproj = torch.maximum(d0, d1)
    gate = (
        proj.ok[:, None]
        & f_valid[None, :]
        & (d_ang < angle_th)
        & (len_ratio > len_ratio_th)
        & (ov > overlap_th)
        & (reproj < reproj_th)
    )
    m = matching.best_matches(dist, gate, max_dist=1 << 19)
    ok = m.ok & (m.dist <= int(desc_th))
    m = matching._masked(ok, m.idx, m.dist)
    return matching.dedupe_targets(m, f_ep.shape[0])


def _f32(x: float) -> float:
    """Round a python float to float32, as a jnp.float32 scalar would be."""
    return float(torch.tensor(x, dtype=torch.float32))


def match_lines(
    proj: ProjectedLines,
    map_desc: torch.Tensor,    # (N, 72) uint8
    f_ep: torch.Tensor,        # (M, 2, 2) frame keyline endpoints
    f_angle: torch.Tensor,     # (M,)
    f_length: torch.Tensor,    # (M,)
    f_desc: torch.Tensor,      # (M, 72)
    f_valid: torch.Tensor,     # (M,)
    cfg: LineConfig,
    allow_relax: bool = True,
) -> matching.MatchResult:
    """Gate-cascade line matching with the reference's relaxed retry.

    If matches / n_frame_lines < cfg.low_match_ratio, thresholds are relaxed
    by cfg.relax_offsets = (angle+10deg, ratio-0.1, overlap-0.1, desc+0.2,
    reproj+10) (LineMatcher.cpp:235-261). Both passes are computed; the
    relaxed result is selected branchlessly when the strict pass is weak.
    """
    # scale the quantized squared-L2 into the Hamming-era range (<=504) so
    # the shared match machinery's constants (BIG, the dedupe key clamp)
    # stay valid
    dist = lbd_mod.lbd_distance_matrix(map_desc, f_desc) // 256
    q = float(lbd_mod.quantize_distance_threshold(1.0)) / 256.0
    deg = math.pi / 180.0
    strict = _gate_and_match(
        proj, f_ep, f_angle, f_length, f_valid, dist,
        _f32(cfg.angle_th_deg * deg), _f32(cfg.length_ratio_th),
        _f32(cfg.overlap_th), _f32(cfg.desc_dist_th * q), _f32(cfg.reproj_err_th),
    )
    if not allow_relax:  # fusion wants the conservative cascade only
        return strict
    ra, rl, ro, rd, rr = cfg.relax_offsets
    relaxed = _gate_and_match(
        proj, f_ep, f_angle, f_length, f_valid, dist,
        _f32((cfg.angle_th_deg + ra) * deg), _f32(cfg.length_ratio_th + rl),
        _f32(cfg.overlap_th + ro), _f32((cfg.desc_dist_th + rd) * q),
        _f32(cfg.reproj_err_th + rr),
    )
    n_frame = f_valid.sum(dtype=torch.int32).clamp(min=1)
    weak = strict.count.float() < cfg.low_match_ratio * n_frame.float()
    return matching.MatchResult(
        torch.where(weak, relaxed.idx, strict.idx),
        torch.where(weak, relaxed.dist, strict.dist),
        torch.where(weak, relaxed.ok, strict.ok),
    )
