"""Line Band Descriptor (LBD) — batched, uint8-quantized float descriptor.

Equivalent of the OpenCV ``BinaryDescriptor::compute`` (LBD, Zhang & Koch
2013) the reference calls in ``LineExtractor::ExtractLineSegment``
(LineExtractor.cpp:21,56). For each segment, gradients are sampled on a
line-aligned band grid (9 bands x rows x S columns), accumulated into
per-band mean/std statistics of the four half-wave gradient projections —
the classic LBD 72-dim float descriptor, unit-normalized per half and
quantized to uint8 in [0, 127], as in the JAX package.

``lbd_distance_matrix`` is the flip-invariant quantized squared-L2 between
descriptors. It is integer-exact: the products are summed in float64
(every partial sum is an integer far below 2^53), never in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LineConfig

_S = 12             # samples along the line
_ROWS_PER_BAND = 3  # perpendicular samples per band

LBD_DIM = 72     # 9 bands x (4 mean + 4 std) channels
_QSCALE = 127.0  # unit-norm halves quantized to [0, 127] uint8


def _flip_perm(nb: int = 9) -> np.ndarray:
    """Index permutation mapping desc(line) -> desc(line with endpoints
    swapped): band order reverses, and the +/- half-wave channels swap
    within both the mean block (0..3) and the std block (4..7)."""
    chan = np.array([1, 0, 3, 2, 5, 4, 7, 6], np.int32)
    perm = np.zeros(nb * 8, np.int32)
    for b in range(nb):
        perm[b * 8 : b * 8 + 8] = (nb - 1 - b) * 8 + chan
    return perm


_FLIP_PERM = _flip_perm()


def _sample_nearest(imgmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sampling of (..., H, W) maps via one linearized gather
    per image."""
    h, w = imgmap.shape[-2:]
    xi = torch.round(x).to(torch.int64).clamp(0, w - 1)
    yi = torch.round(y).to(torch.int64).clamp(0, h - 1)
    lead = imgmap.shape[:-2]
    flat = (yi * w + xi).reshape(lead + (-1,))
    return imgmap.reshape(lead + (-1,)).gather(-1, flat).reshape(xi.shape)


def lbd_descriptors(
    gx: torch.Tensor,
    gy: torch.Tensor,
    endpoints: torch.Tensor,  # (..., NL, 2, 2)
    valid: torch.Tensor,      # (..., NL)
    cfg: LineConfig,
) -> torch.Tensor:
    """Quantized LBD descriptors (..., NL, 72) uint8 from precomputed
    gradients (..., H, W).

    Layout: band-major, [mean+, mean-, meanpar+, meanpar-,
    std+, std-, stdpar+, stdpar-] per band; each 36-dim half is
    unit-normalized then scaled by 127."""
    dev = gx.device
    nb, bw = cfg.lbd_n_bands, cfg.lbd_band_width
    rpb = _ROWS_PER_BAND
    rows = nb * rpb

    s = endpoints[..., 0, :]  # (..., NL, 2)
    e = endpoints[..., 1, :]
    d = e - s
    length = torch.sqrt((d**2).sum(-1, keepdim=True)) + 1e-6
    d = d / length                      # unit along-line dir (..., NL, 2)
    n = torch.stack([-d[..., 1], d[..., 0]], -1)  # unit normal

    ts = (torch.arange(_S, device=dev, dtype=torch.float32) + 0.5) / _S  # (S,)
    stride = bw / rpb
    offs = ((torch.arange(rows, device=dev, dtype=torch.float32) + 0.5) * stride
            - (nb * bw) / 2.0)  # (rows,)

    # sample positions: (..., NL, S, rows, 2)
    base = s[..., :, None, :] + ts[None, :, None] * (e - s)[..., :, None, :]
    pos = base[..., :, :, None, :] + offs[None, None, :, None] * n[..., :, None, None, :]
    x = pos[..., 0]
    y = pos[..., 1]
    sg_x = _sample_nearest(gx, x, y)  # (..., NL, S, rows)
    sg_y = _sample_nearest(gy, x, y)
    g_par = sg_x * d[..., :, None, None, 0] + sg_y * d[..., :, None, None, 1]
    g_perp = sg_x * n[..., :, None, None, 0] + sg_y * n[..., :, None, None, 1]

    # global Gaussian row weighting (LBD paper f_g)
    sigma_g = 0.5 * (nb * bw - 1)
    wg = torch.exp(-(offs**2) / (2 * sigma_g**2))  # (rows,)

    # half-wave rectified projections, band-accumulated over rows
    feats = torch.stack(
        [g_perp.clamp(min=0.0), (-g_perp).clamp(min=0.0),
         g_par.clamp(min=0.0), (-g_par).clamp(min=0.0)],
        dim=-1,
    )  # (..., NL, S, rows, 4)
    feats = feats * wg[None, None, :, None]
    lead_nl = endpoints.shape[:-2]
    band = feats.reshape(lead_nl + (_S, nb, rpb, 4)).sum(-2)  # (..., NL, S, nb, 4)

    mean = band.mean(-3)                         # (..., NL, nb, 4)
    std = torch.sqrt(((band - mean[..., None, :, :]) ** 2).mean(-3))  # population std

    def unit(x):  # normalize mean-part and std-part separately (LBD paper)
        norm = torch.linalg.vector_norm(x.reshape(lead_nl + (-1,)), dim=-1)
        return x / (norm[..., None, None] + 1e-6)

    desc = torch.cat([unit(mean), unit(std)], -1)  # (..., NL, nb, 8) in [0, 1]
    q = torch.round(desc * _QSCALE).clamp(0, 255).to(torch.uint8)
    return torch.where(valid[..., None], q.reshape(lead_nl + (LBD_DIM,)),
                       torch.zeros((), dtype=torch.uint8, device=dev))


def lbd_distance_matrix(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """(..., N, M) int32 flip-invariant squared-L2 between quantized
    descriptors (..., N, 72) and (..., M, 72), over any leading batch.

    Normalized units: divide by 127^2 (config thresholds are stored in
    normalized squared-L2 — see LineConfig.desc_dist_th)."""
    a = a_u8.to(torch.float64)
    b = b_u8.to(torch.float64)
    af = a[..., torch.as_tensor(_FLIP_PERM, device=a.device, dtype=torch.int64)]
    na = (a * a).sum(-1)           # flip preserves the norm
    nb_ = (b * b).sum(-1)
    d = na[..., :, None] + nb_[..., None, :] - 2 * (a @ b.mT)
    df = na[..., :, None] + nb_[..., None, :] - 2 * (af @ b.mT)
    return torch.minimum(d, df).to(torch.int32)


def quantize_distance_threshold(th_normalized: float) -> int:
    """Normalized squared-L2 threshold -> quantized int32 units."""
    return int(round(th_normalized * _QSCALE * _QSCALE))
