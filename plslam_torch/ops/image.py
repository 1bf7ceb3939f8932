"""Basic image ops: pyramid resize, Gaussian blur, gradients.

Equivalents of the OpenCV calls the reference makes (``cv::resize`` in
ORBextractor::ComputePyramid, ORBextractor.cc:1107-1132,
``cv::GaussianBlur(7,7,2,2)`` at :1084).

The blur and Sobel stencils are written as shifted adds over a reflect pad,
in the same order and in float32, exactly like the JAX package — NOT as
``F.conv2d``: cuDNN runs float32 convolutions in TF32 by default and sums
in another order, and either change flips FAST thresholds downstream.

Every function takes images (..., H, W): optional leading batch axes (B
sequences tracked in one step) run through the same operations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) like the reference's mvScaleFactor pyramid."""
    shapes = []
    for l in range(n_levels):
        s = scale**l
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with half-pixel centers
    (cv::INTER_LINEAR semantics, no antialias)."""
    h, w = img.shape[-2:]
    out = F.interpolate(img.reshape(-1, 1, h, w), size=out_hw, mode="bilinear",
                        align_corners=False, antialias=False)
    return out.reshape(img.shape[:-2] + tuple(out_hw))


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """Image pyramid of (..., H, W); level l is resized from level l-1 (like
    the reference)."""
    h, w = img.shape[-2:]
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 pad of ``r`` on a length-``n`` axis
    (numpy/OpenCV 'reflect': the edge sample is not repeated)."""
    idx = np.pad(np.arange(n), (r, r), mode="reflect")
    return torch.as_tensor(idx, device=device)


def _sep_stencil(img: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """1D stencil along an image axis (0: rows, 1: columns) as shifted adds
    over a reflect pad."""
    r = len(k) // 2
    h, w = img.shape[-2:]
    if axis == 0:
        x = img.index_select(-2, _reflect_index(h, r, img.device))
    else:
        x = img.index_select(-1, _reflect_index(w, r, img.device))
    out = None
    for i, kv in enumerate(k):
        s = x[..., i:i + h, :] if axis == 0 else x[..., :, i:i + w]
        term = s * float(kv)
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 borders (OpenCV default)."""
    k = _gaussian_kernel_1d(ksize, sigma)
    x = _sep_stencil(img, k, 1)
    return _sep_stencil(x, k, 0)


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel dx, dy with reflect borders. Returns (gx, gy), same shape."""
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    gx = _sep_stencil(_sep_stencil(img, d, 1), s, 0)
    gy = _sep_stencil(_sep_stencil(img, s, 1), d, 0)
    return gx, gy
