"""FAST-9/16 corner detection on whole images, plus its CUDA kernel.

Replaces the per-cell ``cv::FAST`` calls of the reference's
``ORBextractor::ComputeKeyPointsOctTree`` (ORBextractor.cc:765-853). The
plain version processes the whole image at once: 16 rolled copies of the
image give the Bresenham circle, a circular min over 9-windows gives the
corner score (the largest threshold for which the pixel stays a corner,
matching cv::FAST's score), and a 3x3 max-pool gives non-max suppression.

``fast_score_nms_levels`` scores a whole pyramid, of one image or of a
batch of images (B sequences tracked in one step; each level (B, H, W)): on
CUDA tensors it makes one launch of the hand-written kernel
``csrc/fast_score_nms.cu`` for all levels of all images (bit-identical), on
CPU tensors it runs the plain version per level. ``fast_score_nms`` is the
same for one level. Every function here takes optional leading batch axes;
an unbatched call runs the same operations without them.

Selection keeps the JAX package's tie order: lowest index first among equal
scores (FAST scores are integer-valued on integer images, so ties are
common). ``torch.topk`` does not promise an order among ties, so every
top-k here is a stable descending sort, sliced.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

# Bresenham circle of radius 3, 16 points, circular order (dx, dy), y down.
CIRCLE_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # contiguous arc length for FAST-9


def fast_score_map(img: torch.Tensor, min_threshold: float) -> torch.Tensor:
    """Corner-score map. score[y,x] > t  <=>  pixel is a FAST-9 corner at
    threshold t. Pixels below ``min_threshold`` (and a 3px border) score 0.

    Args:
      img: (..., H, W) float32 grayscale.
      min_threshold: lowest threshold of interest (reference minThFAST=7).
    """
    # shifted[k][..., y, x] = img[..., y + dy_k, x + dx_k]
    shifted = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dx, dy in CIRCLE_OFFSETS]
    )
    d = shifted - img[None]  # (16, ..., H, W)

    def arc_min(x):
        """m[k] = min(x[k], ..., x[k + ARC_LEN - 1]) circular along axis 0."""
        m = torch.minimum(x, torch.roll(x, -1, 0))        # window 2
        m = torch.minimum(m, torch.roll(m, -2, 0))        # window 4
        m = torch.minimum(m, torch.roll(m, -4, 0))        # window 8
        return torch.minimum(m, torch.roll(x, -(ARC_LEN - 1), 0))  # window 9

    score_bright = arc_min(d).amax(0)    # largest t with a bright arc
    score_dark = arc_min(-d).amax(0)     # largest t with a dark arc
    score = torch.maximum(score_bright, score_dark)
    zero = torch.zeros_like(score)
    score = torch.where(score > min_threshold, score, zero)
    # kill the 3px border that the rolls wrapped around
    h, w = img.shape[-2:]
    inside = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    inside[3:h - 3, 3:w - 3] = True
    return torch.where(inside, score, zero)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression of (..., H, W): keep score only at local maxima."""
    h, w = score.shape[-2:]
    m = F.max_pool2d(score.reshape(-1, 1, h, w), 3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= m, score, torch.zeros_like(score))


def fast_score_nms_plain(img: torch.Tensor, min_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: nms3x3(fast_score_map(img)) of
    (..., H, W) images."""
    return nms3x3(fast_score_map(img.float(), min_threshold))


class _FastLevel(ctypes.Structure):
    """``FastLevel`` of ``csrc/fast_score_nms.cu``."""

    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("h", ctypes.c_int), ("w", ctypes.c_int), ("stride", ctypes.c_longlong)]


MAX_LEVELS_PER_LAUNCH = 8  # MAX_LEVELS of the kernel's level table


def fast_score_nms_levels(levels: list[torch.Tensor],
                          min_threshold: float) -> list[torch.Tensor]:
    """NMS'd FAST-9 corner-score maps of every image in ``levels`` (each
    (..., H, W) float32, 0..255, all with the same leading axes; typically a
    pyramid of one image, or of a batch of B images).

    CUDA tensors go through the kernel (``csrc/fast_score_nms.cu``), one
    launch for up to 8 levels of all the images of the batch; CPU tensors
    through :func:`fast_score_nms_plain`, level by level. Both give the same
    bits.
    """
    if not levels:
        return []
    dev = levels[0].device
    if dev.type == "cpu":
        return [fast_score_nms_plain(lvl, min_threshold) for lvl in levels]
    if dev.type != "cuda":
        raise ValueError(f"fast_score_nms: unsupported device {dev}")
    if not min_threshold >= 0:
        raise ValueError("fast_score_nms: the kernel needs min_threshold >= 0, "
                         f"got {min_threshold}")
    lead = levels[0].shape[:-2]
    for lvl in levels:
        if lvl.device != dev or lvl.dtype != torch.float32 or lvl.dim() < 2 \
                or lvl.shape[:-2] != lead or not lvl.is_contiguous():
            raise ValueError("fast_score_nms: needs contiguous (..., H, W) float32 "
                             f"tensors with the leading axes {tuple(lead)} on {dev}, got "
                             f"{tuple(lvl.shape)} {lvl.dtype} on {lvl.device}")
        if lvl.numel() == 0:
            raise ValueError("fast_score_nms: empty image")
    n_images = levels[0].numel() // (levels[0].shape[-2] * levels[0].shape[-1])
    if n_images > 65535:
        raise ValueError(f"fast_score_nms: at most 65535 images, got {n_images}")
    fn = cuda_build.function("fast_score_nms", "fast_score_nms_launch",
                             [ctypes.POINTER(_FastLevel), ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_void_p])
    outs = [torch.empty_like(lvl) for lvl in levels]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(levels), MAX_LEVELS_PER_LAUNCH):
            part = range(i, min(i + MAX_LEVELS_PER_LAUNCH, len(levels)))
            table = (_FastLevel * len(part))(*[
                _FastLevel(levels[j].data_ptr(), outs[j].data_ptr(), *levels[j].shape[-2:],
                           levels[j].shape[-2] * levels[j].shape[-1])
                for j in part])
            err = fn(table, len(part), n_images, float(min_threshold), stream)
            if err != 0:
                raise RuntimeError(f"fast_score_nms kernel launch failed: cudaError {err}")
            fast_score_nms.launches += 1
    return outs


def fast_score_nms(img: torch.Tensor, min_threshold: float) -> torch.Tensor:
    """NMS'd FAST-9 corner-score map of ``img`` ((..., H, W) float32, 0..255).

    :func:`fast_score_nms_levels` on a one-level table: the kernel on a CUDA
    tensor, :func:`fast_score_nms_plain` on a CPU tensor, the same bits.
    """
    return fast_score_nms_levels([img], min_threshold)[0]


# launches of the kernel, by fast_score_nms_levels and fast_score_nms alike
fast_score_nms.launches = 0


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """Top-k along ``dim``, descending, lowest index first among ties (the
    order of ``lax.top_k`` and of repeated first-argmax rounds)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def detect_cellwise(
    score: torch.Tensor,
    ini_threshold: float,
    cell: int,
    k_per_cell: int,
    border: int,
):
    """Spatially-balanced keypoint selection with per-cell threshold fallback.

    Reference semantics (ORBextractor.cc:790-850): each ~30px cell is detected
    at iniThFAST, and if the cell produced nothing, at minThFAST. Here: if a
    cell's best score exceeds ``ini_threshold`` only keypoints above it
    survive; otherwise the lower threshold already baked into ``score``
    applies. Top-``k_per_cell`` per cell replaces the sequential quadtree
    (DistributeOctTree, :539).

    ``score`` is (..., H, W). Returns (ys, xs, resp) of shape
    (..., n_cells * k_per_cell) — zero-resp entries are invalid.
    """
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    inside = torch.zeros((h, w), dtype=torch.bool, device=score.device)
    inside[border:h - border, border:w - border] = True
    score = torch.where(inside, score, torch.zeros_like(score))

    hp = -(-h // cell) * cell
    wp = -(-w // cell) * cell
    sp = F.pad(score, (0, wp - w, 0, hp - h))
    nch, ncw = hp // cell, wp // cell
    cells = sp.reshape(lead + (nch, cell, ncw, cell)).transpose(-3, -2).reshape(
        lead + (nch * ncw, cell * cell)
    )
    if k_per_cell > cells.shape[-1]:
        raise ValueError(f"detect_cellwise: k={k_per_cell} > cell size {cells.shape[-1]}")
    cell_max = cells.amax(-1, keepdim=True)
    eff_th = torch.where(cell_max > ini_threshold,
                         torch.full_like(cell_max, ini_threshold),
                         torch.zeros_like(cell_max))
    cells = torch.where(cells > eff_th, cells, torch.zeros_like(cells))

    vals, idx = stable_topk(cells, k_per_cell)  # (..., n_cells, k)
    cid = torch.arange(nch * ncw, device=score.device)[:, None]
    py = (cid // ncw) * cell + idx // cell
    px = (cid % ncw) * cell + idx % cell
    flat = lead + (-1,)
    return (py.reshape(flat).to(torch.int32), px.reshape(flat).to(torch.int32),
            vals.reshape(flat))


def top_n_keypoints(ys, xs, resp, n: int):
    """Global top-n by response from the per-cell candidates (along the last
    axis); invalid entries (resp==0) sort to the end. Returns (ys, xs, resp,
    valid) each (..., n)."""
    vals, order = stable_topk(resp, n)
    return ys.gather(-1, order), xs.gather(-1, order), vals, vals > 0.0
