"""Frozen roofline arithmetic of the two hand kernels on one NVIDIA H100 SXM.

Constants: the HBM3 rate, 3.35 TB/s, and the float32 rate, 67 TFLOP/s
counted as fused multiply-adds (NVIDIA's data sheet, at the 700 W limit).
Instructions that are not fused multiply-adds (sub, compare) issue at half
that rate; float32 min/max at half that again, 64 per clock per SM, as the
card was measured to issue them (an earlier measurement, kept here as a
constant so that the yardstick does not move). A bound is the larger of the
bytes over the memory rate and the operations over their rate; each input
byte is read once and each output byte written once.
"""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12 / 2
MINMAX_OPS_S = FP32_OPS_S / 2
# FAST, per pixel: the compass pre-test (4 sub, 8 compares, 8 and/or), the
# separable 3x3 NMS (4 max) and 1 compare; per side (bright, dark) that
# passes the pre-test: the best of its 16 arc minima, 63 min/max when
# neighbouring arcs share their 7 common points, 1 sub and 1 compare
FAST_OPS_PER_PX, FAST_MINMAX_PER_PX = 21, 4
FAST_OPS_PER_SIDE, FAST_MINMAX_PER_SIDE = 2, 63
# Hamming top-2 writes best, index and second (int32) per query row
HAMMING_OUT_BYTES_PER_ROW = 12


def bound_s(nbytes: float, ops: float, ops_rate: float) -> float:
    """Least seconds for ``nbytes`` of memory traffic and ``ops`` operations."""
    return max(nbytes / HBM_BYTES_S, ops / ops_rate)


def pretest_sides(img: torch.Tensor, th: float) -> int:
    """Bright and dark sides of the pixels 3 px inside each (H, W) image of
    ``img`` (..., H, W) that pass FAST's compass pre-test: two adjacent
    compass points of the circle (dy = 3, dx = 3, dy = -3, dx = -3) beyond
    +-th on that side. These are the arcs the kernel has to evaluate."""
    h, w = img.shape[-2:]
    c = img[..., 3:h - 3, 3:w - 3]
    d = [img[..., 6:h, 3:w - 3] - c, img[..., 3:h - 3, 6:w] - c,
         img[..., 0:h - 6, 3:w - 3] - c, img[..., 3:h - 3, 0:w - 6] - c]
    bright = torch.zeros_like(c, dtype=torch.bool)
    dark = torch.zeros_like(bright)
    for k in range(4):
        a, b = d[k], d[(k + 1) % 4]
        bright |= (a > th) & (b > th)
        dark |= (a < -th) & (b < -th)
    return int(bright.sum()) + int(dark.sum())


def fast_bound_s(npx: int, nsides: int) -> float:
    """FAST score + NMS over ``npx`` pixels of which ``nsides`` sides pass
    the pre-test: float32 read and written once, against the operations,
    min/max counted at their own issue rate."""
    ops = (FAST_OPS_PER_PX * npx + FAST_OPS_PER_SIDE * nsides
           + (FAST_MINMAX_PER_PX * npx + FAST_MINMAX_PER_SIDE * nsides)
           * FP32_OPS_S / MINMAX_OPS_S)
    return bound_s(8 * npx, ops, FP32_OPS_S)


def hamming_bound_s(n_problems: int, n: int, m: int, shared_queries: bool) -> float:
    """Gated Hamming top-2 of ``n_problems`` problems of ``n`` queries and
    ``m`` targets (32-byte descriptors), the (n, m) gate as one byte a pair:
    queries, targets, gate and outputs moved once, over the memory rate."""
    q = 32 * n * (1 if shared_queries else n_problems)
    nbytes = q + n_problems * (32 * m + n * m + HAMMING_OUT_BYTES_PER_ROW * n)
    return nbytes / HBM_BYTES_S
