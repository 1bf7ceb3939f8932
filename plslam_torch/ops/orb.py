"""ORB feature extraction on torch tensors.

The reference's ``ORBextractor`` (ORBextractor.cc): 8-level pyramid,
FAST-9 with per-cell threshold fallback, spatially-balanced top-k selection
(replacing the sequential quadtree ``DistributeOctTree`` :539),
intensity-centroid orientation (:77-105), 7x7 Gaussian blur and the
256-pair rotated-BRIEF descriptor (:108-144, pattern table :150-447 →
``orb_pattern.npy``, a byte-identical copy of the JAX package's table).

Descriptors are OpenCV's ORB byte layout (same pattern, same rounding) and
bit-identical to the JAX package's on identical keypoints and angles. The
FAST score+NMS of all levels is one ``fast.fast_score_nms_levels`` call, one
launch of the CUDA kernel on CUDA tensors. Every function takes optional
leading batch axes on the image (B sequences tracked in one step: one FAST
launch for all B pyramids); an unbatched call runs the same operations
without them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import OrbConfig
from . import fast, image
from .batch import each, pixels_at, rowwise

HALF_PATCH = 15

_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))


def _umax_table() -> np.ndarray:
    """Row half-widths of the discrete radius-15 circle, exactly as the
    reference builds them (ORBextractor.cc ctor) so moments match OpenCV."""
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH * HALF_PATCH - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


class OrbFeatures(NamedTuple):
    """Padded per-frame keypoint arrays (level-0 pixel coordinates); with a
    batch of images every field has the batch's leading axes."""

    xy: torch.Tensor        # (N, 2) float32, raw (distorted) image coords
    response: torch.Tensor  # (N,) float32
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) float32 degrees, [0, 360)
    desc: torch.Tensor      # (N, 32) uint8 — OpenCV-compatible byte layout
    valid: torch.Tensor     # (N,) bool

    @property
    def n(self) -> int:
        return self.xy.shape[-2]


def _per_level_budget(cfg: OrbConfig) -> list[int]:
    """Distribute nFeatures over levels by 1/scale per level
    (ORBextractor.cc:52-75 semantics)."""
    f = 1.0 / cfg.scale_factor
    n_desired = cfg.n_features * (1 - f) / (1 - f**cfg.n_levels)
    budget = []
    acc = 0
    for l in range(cfg.n_levels - 1):
        n = int(round(n_desired * f**l))
        budget.append(n)
        acc += n
    budget.append(max(cfg.n_features - acc, 0))
    return budget


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1)


def ic_moment_maps(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense intensity-centroid moment maps (m10, m01) over the whole image.

    For each patch row v the circular mask has half-width umax[|v|], so

        m10(y,x) = sum_v [ Sx(y+v, x; d) - x * S(y+v, x; d) ]
        m01(y,x) = sum_v  v * S(y+v, x; d),   d = umax[|v|]

    where S / Sx are width-(2d+1) windowed sums of I and x*I, O(1) per pixel
    via cumsum differences. ``img`` is (..., H, W).
    """
    h, w = img.shape[-2:]
    umax = _umax_table()
    r = HALF_PATCH
    # pad x for window reads, y for row shifts
    xpad = torch.nn.functional.pad(img, (r + 1, r, r, r))
    xs = torch.arange(-(r + 1), w + r, dtype=torch.float32, device=img.device)
    # each image alone: on the card a batch's float cumsum sums in another order
    cum = each(_cumsum_rows, img.shape[:-2], xpad)
    cumx = each(_cumsum_rows, img.shape[:-2], xpad * xs[None, :])

    def winsum(c, d):
        # window [x-d, x+d] of the original image, for all x in [0, w)
        return c[..., :, r + 1 + d: r + 1 + d + w] - c[..., :, r - d: r - d + w]

    x_coord = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    uniq = sorted(set(int(v) for v in umax))
    S = {d: winsum(cum, d) for d in uniq}          # (..., h+2r, w)
    SxI = {d: winsum(cumx, d) for d in uniq}
    m10 = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    m01 = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for v in range(-r, r + 1):
        d = int(umax[abs(v)])
        s_row = S[d][..., v + r: v + r + h, :]
        sx_row = SxI[d][..., v + r: v + r + h, :]
        m10 = m10 + (sx_row - x_coord * s_row)
        m01 = m01 + float(v) * s_row
    return m10, m01


def ic_angles(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (degrees) for keypoints at integer
    (ys, xs) (..., N) on ``img`` (..., H, W)."""
    m10, m01 = ic_moment_maps(img)
    h, w = img.shape[-2:]
    at = ys.long().clamp(0, h - 1) * w + xs.long().clamp(0, w - 1)
    ang = rowwise(torch.atan2, pixels_at(m01, at), pixels_at(m10, at)) * np.float32(180.0 / np.pi)
    return torch.where(ang < 0, ang + 360.0, ang)


def _rotated_offsets(angles_deg: torch.Tensor):
    """OpenCV GET_VALUE rotation: x' = round(px·a − py·b), y' = round(px·b +
    py·a) for every pattern point (ORBextractor.cc:108-144)."""
    theta = angles_deg * np.float32(np.pi / 180.0)
    a, b = rowwise(torch.cos, theta), rowwise(torch.sin, theta)  # (..., N)
    pat = torch.as_tensor(_PATTERN, dtype=torch.float32, device=angles_deg.device)
    px, py = pat[:, 0], pat[:, 1]  # (512,)
    rx = torch.round(px * a[..., None] - py * b[..., None]).long()
    ry = torch.round(px * b[..., None] + py * a[..., None]).long()
    return rx, ry


def _pack_bits(vals: torch.Tensor) -> torch.Tensor:
    """(..., N, 512) sampled values → (..., N, 32) uint8, OpenCV byte layout:
    byte j bit b (LSB-first) encodes pattern pair 8j+b; bit set iff
    I(p1) < I(p2)."""
    bits = (vals[..., 0::2] < vals[..., 1::2]).to(torch.int32)  # (..., N, 256)
    shifts = torch.arange(8, dtype=torch.int32, device=vals.device)
    return (bits.reshape(bits.shape[:-1] + (32, 8)) << shifts).sum(-1).to(torch.uint8)


def brief_descriptors(blurred: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF 256-bit descriptors (OpenCV-compatible bytes), by a
    direct per-sample gather; ``blurred`` (..., H, W), keypoints (..., N)."""
    h, w = blurred.shape[-2:]
    rx, ry = _rotated_offsets(angles_deg)
    yy = (ys.long()[..., None] + ry).clamp(0, h - 1)
    xx = (xs.long()[..., None] + rx).clamp(0, w - 1)
    return _pack_bits(pixels_at(blurred, yy * w + xx))  # values (..., N, 512)


def extract_orb(img: torch.Tensor, cfg: OrbConfig) -> OrbFeatures:
    """Full ORB extraction for one grayscale frame (float32, 0..255), or a
    batch of frames (..., H, W).

    Returns fixed-capacity ``OrbFeatures`` (cfg.max_keypoints rows).
    """
    img = img.float()
    lead = img.shape[:-2]
    levels = image.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budget = _per_level_budget(cfg)
    n = cfg.max_keypoints
    pad = n - sum(budget)
    if pad < 0:
        raise ValueError("max_keypoints smaller than per-level budget sum")

    xs_all, ys_all, resp_all, oct_all, ang_all, desc_all, valid_all = (
        [], [], [], [], [], [], []
    )
    scores = fast.fast_score_nms_levels(levels, float(cfg.min_th_fast))
    for l, (lvl, score) in enumerate(zip(levels, scores)):
        cys, cxs, cresp = fast.detect_cellwise(
            score,
            float(cfg.ini_th_fast),
            cfg.cell_size,
            cfg.max_kp_per_cell,
            cfg.edge_threshold,
        )
        ys, xs, resp, valid = fast.top_n_keypoints(cys, cxs, cresp, budget[l])
        ang = ic_angles(lvl, ys, xs)
        blurred = image.gaussian_blur(lvl)
        desc = brief_descriptors(blurred, ys, xs, ang)
        s = cfg.scale_factor**l
        xs_all.append(xs.float() * s)
        ys_all.append(ys.float() * s)
        resp_all.append(resp)
        oct_all.append(torch.full(lead + (budget[l],), l, dtype=torch.int32,
                                  device=img.device))
        ang_all.append(ang)
        desc_all.append(desc)
        valid_all.append(valid)

    # the keypoint axis follows the batch's leading axes
    kd = len(lead)

    def cat_pad(parts, value=0):
        x = torch.cat(parts, kd)
        shape = list(x.shape)
        shape[kd] = pad
        return torch.cat([x, x.new_full(shape, value)], kd)

    xy = torch.stack([torch.cat(xs_all, kd), torch.cat(ys_all, kd)], -1)
    return OrbFeatures(
        xy=cat_pad([xy]),
        response=cat_pad(resp_all),
        octave=cat_pad(oct_all),
        angle=cat_pad(ang_all),
        desc=cat_pad(desc_all),
        valid=cat_pad(valid_all, False),
    )
