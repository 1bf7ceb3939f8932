"""Line-segment detection with dense parallel primitives.

Replaces the OpenCV ``LSDDetector::detect`` call wrapped by the reference's
``LineExtractor`` (LineExtractor.cpp:18-35). Classic LSD region-growing is
sequential; this detector keeps its signal model (pixels support a line
when their gradient is strong and perpendicular to it) but finds segments
with dense tensor ops — the same algorithm, constants and tie order as the
JAX package:

 1. Sobel gradients; keep the top-P strongest pixels (sparse working set).
 2. Quantize line orientation (mod pi) into B bins with +/- tolerance.
 3. Per-bin Hough-like histogram over the perpendicular offset rho;
    1D NMS + top-K peaks -> (theta, rho) candidates.
 4. Per candidate: support pixels within a rho corridor, reduced to the
    strongest S per candidate, sorted along the line direction; the longest
    gap-tolerant run over the sorted projections gives the segment extent.
 5. Weighted PCA of the run's support pixels refines angle/offset to
    sub-pixel; endpoints = extreme projections of supports onto the fit.
 6. Candidate NMS (same orientation + offset + overlapping extent), then
    keep the longest ``keep_top`` segments — the reference's
    response = length / max(W, H) ranking (LineExtractor.cpp:23-35).

Every top-k is exact with the lowest index first among ties (the JAX
package's ``approx_max_k`` is an exact top-k off the TPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import LineConfig
from ..geometry.lines import line_equation_2d
from . import image
from .fast import stable_topk


class LineFeatures(NamedTuple):
    """Padded per-frame line arrays (pixel coordinates)."""

    endpoints: torch.Tensor  # (NL, 2, 2) [start(x,y), end(x,y)]
    angle: torch.Tensor      # (NL,) radians in (-pi, pi], gradient-oriented
    length: torch.Tensor     # (NL,)
    response: torch.Tensor   # (NL,) length / max(W, H)
    coeff: torch.Tensor      # (NL, 3) normalized homogeneous 2D line
    valid: torch.Tensor      # (NL,) bool


# static working-set sizes (the JAX package's lsd.py:52-62)
_P = 12288         # sparse strong-gradient pixel budget (Hough voting)
_P_RUN = 4096      # subset used for per-candidate support/run finding
_K_PER_BIN = 8     # rho peaks kept per orientation bin
_S_SUP = 512       # strongest supports kept per candidate; only delimits the
                   # run extent — the PCA fit uses all _P_RUN supports

_PI = math.pi  # python float: cast to f32 per op, as the JAX package does


def _fmod_pi(x: torch.Tensor) -> torch.Tensor:
    """x mod pi with the sign of the divisor (jnp.mod semantics)."""
    return torch.remainder(x, _PI)


def detect_lines(img: torch.Tensor, cfg: LineConfig, hw: tuple[int, int]) -> LineFeatures:
    h, w = hw
    dev = img.device
    img = img.float()
    gx, gy = image.sobel_gradients(image.gaussian_blur(img, 5, 1.0))
    mag = torch.sqrt(gx * gx + gy * gy)

    # Structure-tensor coherence: line/edge pixels have anisotropic local
    # gradients (coherence ~1) while texture/noise is isotropic (~0).
    jxx = image.gaussian_blur(gx * gx, 5, 2.0)
    jxy = image.gaussian_blur(gx * gy, 5, 2.0)
    jyy = image.gaussian_blur(gy * gy, 5, 2.0)
    coherence = torch.sqrt((jxx - jyy) ** 2 + 4.0 * jxy * jxy) / (jxx + jyy + 1e-6)

    # kill borders
    inside = torch.zeros((h, w), dtype=torch.bool, device=dev)
    inside[2:h - 2, 2:w - 2] = True
    gate = inside & (mag > cfg.grad_threshold) & (coherence > 0.6)
    mag = torch.where(gate, mag * coherence, torch.zeros_like(mag))

    # ---- 1. sparse top-P working set -------------------------------------
    flat_mag, flat_idx = stable_topk(mag.reshape(-1), _P)
    py = (flat_idx // w).float()
    px = (flat_idx % w).float()
    pgx = gx.reshape(-1)[flat_idx]
    pgy = gy.reshape(-1)[flat_idx]
    pw = flat_mag
    p_ok = flat_mag > 0.0
    # line direction = gradient rotated 90deg; fold to [0, pi)
    theta_p = _fmod_pi(torch.atan2(pgy, pgx) + _PI / 2)  # (P,)

    # center coordinates so rho spans ~[-diag/2, diag/2]
    cx0, cy0 = (w - 1) / 2.0, (h - 1) / 2.0
    qx, qy = px - cx0, py - cy0

    B = cfg.n_orientation_bins
    NR = int(2 * np.ceil(np.hypot(h, w) / 2 / cfg.rho_bin_px)) + 2
    thetas = torch.arange(B, device=dev, dtype=torch.float32) * (_PI / B)  # (B,)
    tol = _PI / B  # +/- one bin width of angular tolerance

    # angular membership (B, P): distance on the mod-pi circle
    dth = (theta_p[None, :] - thetas[:, None]).abs()
    dth = torch.minimum(dth, _PI - dth)
    inbin = (dth < tol) & p_ok[None, :]

    # rho per (B, P): projection on each bin's normal
    nx = -torch.sin(thetas)[:, None]
    ny = torch.cos(thetas)[:, None]
    rho = qx[None, :] * nx + qy[None, :] * ny  # (B, P)
    rho_idx = (rho / cfg.rho_bin_px + NR / 2).to(torch.int64).clamp(0, NR - 1)

    # ---- 2. Hough histogram + peaks --------------------------------------
    # weights rounded to bf16 as the JAX package's bf16 one-hot contraction
    # rounds them, then summed in f32. bf16 values carry 8 significant bits,
    # so these f32 sums are exact in any order.
    w_b = torch.where(inbin, pw[None, :], torch.zeros_like(rho))
    w_b = w_b.to(torch.bfloat16).float()
    flat_bin = (torch.arange(B, device=dev)[:, None] * NR + rho_idx).reshape(-1)
    hist = torch.zeros(B * NR, device=dev).index_add_(0, flat_bin, w_b.reshape(-1))
    hist = hist.reshape(B, NR)
    # smooth +/-1 bin, then NMS over a 5-bin window
    hist_s = (
        hist * 0.5
        + 0.25 * torch.roll(hist, 1, 1)
        + 0.25 * torch.roll(hist, -1, 1)
    )
    local_max = F.max_pool1d(hist_s[:, None], 5, stride=1, padding=2)[:, 0]
    peaks = torch.where(hist_s >= local_max, hist_s, torch.zeros_like(hist_s))
    peak_val, peak_rho_idx = stable_topk(peaks, _K_PER_BIN, 1)  # (B, K)

    C = B * _K_PER_BIN
    cand_theta = thetas.repeat_interleave(_K_PER_BIN)  # (C,)
    cand_rho = (peak_rho_idx.reshape(-1).float() - NR / 2) * cfg.rho_bin_px
    cand_ok = peak_val.reshape(-1) > (cfg.min_length_px * cfg.grad_threshold * 0.5)

    # ---- 3+4. support -> gap-tolerant run -> PCA fit, iterated ------------
    corridor = 1.5 * cfg.rho_bin_px
    BIG = 1e9

    qx_r, qy_r = qx[:_P_RUN], qy[:_P_RUN]
    theta_r = theta_p[:_P_RUN]
    p_ok_r = p_ok[:_P_RUN]
    pw_r = pw[:_P_RUN]
    pgx_r, pgy_r = pgx[:_P_RUN], pgy[:_P_RUN]
    idx_s = torch.arange(_S_SUP, device=dev)[None, :]

    def gather_fit(mx, my, dx_f, dy_f):
        """Support pixels near the line through (mx,my) dir (dx_f,dy_f):
        keep the strongest _S_SUP per candidate, sort along the line, take
        the longest gap-tolerant run, weighted-PCA fit."""
        ang_line = _fmod_pi(torch.atan2(dy_f, dx_f))
        dthc = (theta_r[None, :] - ang_line[:, None]).abs()
        dthc = torch.minimum(dthc, _PI - dthc)
        ang_gate = (dthc < tol) & p_ok_r[None, :]
        # perpendicular distance to the line
        nxf, nyf = -dy_f, dx_f
        dperp = (
            (qx_r[None, :] - mx[:, None]) * nxf[:, None]
            + (qy_r[None, :] - my[:, None]) * nyf[:, None]
        ).abs()
        sup = ang_gate & (dperp < corridor)
        # polarity split: keep ONE polarity class of a painted stripe's two
        # anti-parallel edges, chosen against a fixed canonical half-plane
        sg = torch.sign(dy_f + 0.2 * dx_f)
        canon = torch.where(sg == 0, torch.ones_like(sg), sg)
        ncx = canon * -dy_f
        ncy = canon * dx_f
        gdot = pgx_r[None, :] * ncx[:, None] + pgy_r[None, :] * ncy[:, None]
        zero = torch.zeros_like(gdot)
        w_sup = torch.where(sup, pw_r[None, :], zero)
        s_pos = torch.where(gdot > 0, w_sup, zero).sum(1)
        s_neg = torch.where(gdot <= 0, w_sup, zero).sum(1)
        pol_pos = s_pos >= 0.3 * (s_pos + s_neg)
        pol_class = torch.where(pol_pos[:, None], gdot > 0, gdot <= 0)
        t = (qx_r[None, :] - mx[:, None]) * dx_f[:, None] + (
            qy_r[None, :] - my[:, None]
        ) * dy_f[:, None]
        # strongest S supports per candidate, weight and quantized t packed
        # into one f32 (w in the high bits, t in the low 12): exact integers
        # below 2^24, and only the values are needed
        w_q = torch.floor(pw_r[None, :].clamp(1.0, 3000.0))
        t_q = torch.floor((t + 2048.0).clamp(0.0, 4095.0))
        pack = torch.where(sup, w_q * 4096.0 + t_q, zero)
        top_pack = torch.topk(pack, _S_SUP, dim=1).values
        ok = top_pack > 0.0
        t_sel = torch.remainder(top_pack, 4096.0) - 2048.0
        # sort support t values along the line; invalids to the end
        ts = torch.sort(torch.where(ok, t_sel, torch.full_like(t_sel, BIG)), 1).values
        ok_s = ts < 0.5 * BIG
        prev = torch.cat([torch.full((C, 1), -BIG, device=dev), ts[:, :-1]], 1)
        newrun = (ts - prev > 2.0 * cfg.gap_tolerance_px) | ~ok_s | (idx_s == 0)
        # t at the start of each element's run: a running max of run-start
        # indices (the segmented "hold" scan), then a gather
        start = torch.cummax(torch.where(newrun, idx_s, torch.zeros_like(idx_s)), 1).values
        ts_start = torch.gather(ts, 1, start)
        # pick the longest run by SPAN along the line
        span = torch.where(ok_s, ts - ts_start, torch.full_like(ts, -1.0))
        best_end = torch.argmax(span, 1, keepdim=True)
        t_lo = torch.gather(ts_start, 1, best_end)[:, 0]
        t_hi = torch.gather(ts, 1, best_end)[:, 0]
        # weighted PCA over ALL supports inside the run extent, over the
        # chosen polarity class only
        in_run = sup & (t >= t_lo[:, None]) & (t <= t_hi[:, None])
        wgt = torch.where(in_run & pol_class, pw_r[None, :], zero)  # (C, P_RUN)
        sw = wgt.sum(1) + 1e-6
        mx2 = (wgt * qx_r[None, :]).sum(1) / sw
        my2 = (wgt * qy_r[None, :]).sum(1) / sw
        dxq = qx_r[None, :] - mx2[:, None]
        dyq = qy_r[None, :] - my2[:, None]
        sxx = (wgt * dxq * dxq).sum(1) / sw
        sxy = (wgt * dxq * dyq).sum(1) / sw
        syy = (wgt * dyq * dyq).sum(1) / sw
        ang2 = 0.5 * torch.atan2(2 * sxy, sxx - syy)
        dx2 = torch.cos(ang2)
        dy2 = torch.sin(ang2)
        flip = dx2 * dx_f + dy2 * dy_f < 0
        dx2 = torch.where(flip, -dx2, dx2)
        dy2 = torch.where(flip, -dy2, dy2)
        t_f = dxq * dx2[:, None] + dyq * dy2[:, None]
        t_min = torch.where(in_run, t_f, torch.full_like(t_f, BIG)).amin(1)
        t_max = torch.where(in_run, t_f, torch.full_like(t_f, -BIG)).amax(1)
        n_sup = in_run.sum(1)
        # mean gradient projected on the refined normal (endpoint ordering)
        in_fit = in_run & pol_class
        gn = torch.where(in_fit, pgx_r[None, :], zero).sum(1) * (-dy2) + (
            torch.where(in_fit, pgy_r[None, :], zero).sum(1) * dx2
        )
        return mx2, my2, dx2, dy2, t_min, t_max, n_sup, gn

    # initial line params from the Hough candidate: anchor = rho * normal
    mx = cand_rho * -torch.sin(cand_theta)
    my = cand_rho * torch.cos(cand_theta)
    dx_f = torch.cos(cand_theta)
    dy_f = torch.sin(cand_theta)
    for _ in range(2):
        mx, my, dx_f, dy_f, t_min, t_max, n_sup, gn = gather_fit(mx, my, dx_f, dy_f)
    t_min = torch.where(t_min >= BIG, torch.full_like(t_min, math.inf), t_min)
    t_max = torch.where(t_max <= -BIG, torch.full_like(t_max, -math.inf), t_max)

    seg_ok = cand_ok & (n_sup >= 8) & torch.isfinite(t_min) & torch.isfinite(t_max)
    t_min = torch.where(seg_ok, t_min, torch.zeros_like(t_min))
    t_max = torch.where(seg_ok, t_max, torch.zeros_like(t_max))
    length = t_max - t_min
    # density gate: supports per pixel of length
    density = n_sup.float() / length.clamp(min=1.0)
    seg_ok = seg_ok & (length >= cfg.min_length_px) & (density > 0.35)

    sx = mx + t_min * dx_f + cx0
    sy = my + t_min * dy_f + cy0
    ex = mx + t_max * dx_f + cx0
    ey = my + t_max * dy_f + cy0

    # ---- 5. candidate NMS -------------------------------------------------
    ang_c = _fmod_pi(torch.atan2(dy_f, dx_f))
    d_ang = (ang_c[:, None] - ang_c[None, :]).abs()
    d_ang = torch.minimum(d_ang, _PI - d_ang)
    # perpendicular offset of centroid j to line i
    nxf, nyf = -dy_f, dx_f
    off = (
        (mx[None, :] - mx[:, None]) * nxf[:, None]
        + (my[None, :] - my[:, None]) * nyf[:, None]
    ).abs()
    # extent overlap along i's direction
    tj_lo = (mx[None, :] + 0 - mx[:, None]) * dx_f[:, None] + (
        my[None, :] - my[:, None]
    ) * dy_f[:, None] + t_min[None, :]
    tj_hi = tj_lo + length[None, :]
    ov_lo = torch.maximum(t_min[:, None], tj_lo)
    ov_hi = torch.minimum(t_max[:, None], tj_hi)
    # duplicates share most of their span; collinear fragments that merely
    # touch are distinct lines
    strong_overlap = (ov_hi - ov_lo) > 0.3 * torch.minimum(
        length[:, None], length[None, :]
    )
    similar = (d_ang < _PI / 36) & (off < 1.5 * cfg.rho_bin_px) & strong_overlap
    # deterministic polarity preference against a fixed half-plane
    canon = torch.sign(dy_f + 0.2 * dx_f)
    gn_c = gn * torch.where(canon == 0, torch.ones_like(canon), canon)
    score = torch.where(seg_ok, length * torch.where(gn_c > 0, 2.0, 1.0),
                        torch.full_like(length, -1.0))
    # suppressed if a similar segment has a strictly better (score, idx) key
    key = score * C - torch.arange(C, device=dev, dtype=torch.float32)
    better = similar & (key[None, :] > key[:, None]) & seg_ok[None, :]
    keep = seg_ok & ~better.any(1)

    # ---- 6. final top-N by length ----------------------------------------
    final_score = torch.where(keep, length, torch.zeros_like(length))
    top_val, top_idx = stable_topk(final_score, cfg.max_lines)
    rank = torch.arange(cfg.max_lines, device=dev)
    valid = (top_val >= cfg.min_length_px) & (rank < cfg.keep_top)

    s_sel = torch.stack([sx[top_idx], sy[top_idx]], -1)
    e_sel = torch.stack([ex[top_idx], ey[top_idx]], -1)
    # orient by mean gradient normal (stable endpoint order across frames)
    swap = (gn[top_idx] < 0)[:, None]
    s_fin = torch.where(swap, e_sel, s_sel)
    e_fin = torch.where(swap, s_sel, e_sel)

    d_fin = e_fin - s_fin
    ang_fin = torch.atan2(d_fin[:, 1], d_fin[:, 0])
    len_fin = torch.sqrt((d_fin**2).sum(-1))
    coeff = line_equation_2d(s_fin, e_fin)
    zero = torch.zeros_like(len_fin)
    return LineFeatures(
        endpoints=torch.stack([s_fin, e_fin], 1),
        angle=torch.where(valid, ang_fin, zero),
        length=torch.where(valid, len_fin, zero),
        response=torch.where(valid, len_fin / max(h, w), zero),
        coeff=torch.where(valid[:, None], coeff, torch.zeros_like(coeff)),
        valid=valid,
    )
