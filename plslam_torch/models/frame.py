"""Per-frame perception: from (gray, depth) to FrameData, RGB-D.

The reference ``Frame`` RGB-D constructor (Frame.cc:97-205): ORB and line
extraction (two pthreads there, :152-155; one stream of device work here),
depth association following ``ComputeStereoFromRGBD`` (:1065-1117): the
virtual-right coordinate u_r = u - bf/d for keypoints, endpoint depths for
keylines, and undistortion following ``UndistortKeyPoints/KeyLines``
(:737-845). Windowed searches use dense gate matrices, so the reference's
64x48 keypoint grid is not built.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..geometry import projection
from ..geometry.lines import line_equation_2d
from ..ops import image, lbd, lsd, orb


class FrameData(NamedTuple):
    """All per-frame arrays (fixed capacity, mask-padded)."""

    # points
    kp_xy: torch.Tensor        # (N, 2) raw keypoint coords
    kp_xy_un: torch.Tensor     # (N, 2) undistorted coords
    kp_resp: torch.Tensor      # (N,)
    kp_octave: torch.Tensor    # (N,) int32
    kp_angle: torch.Tensor     # (N,) degrees
    kp_desc: torch.Tensor      # (N, 32) uint8
    kp_depth: torch.Tensor     # (N,) metres; <=0 when unknown
    kp_ur: torch.Tensor        # (N,) virtual right u; -1 when no depth
    kp_valid: torch.Tensor     # (N,) bool
    # lines
    ln_ep: torch.Tensor        # (NL, 2, 2) raw endpoints
    ln_ep_un: torch.Tensor     # (NL, 2, 2) undistorted endpoints
    ln_angle: torch.Tensor     # (NL,)
    ln_length: torch.Tensor    # (NL,)
    ln_coeff: torch.Tensor     # (NL, 3) from undistorted endpoints
    ln_desc: torch.Tensor      # (NL, 72) uint8 (quantized LBD, ops/lbd.py)
    ln_depth: torch.Tensor     # (NL, 2) endpoint depths; <=0 when unknown
    ln_valid: torch.Tensor     # (NL,) bool


def _unquantize_gray(gray: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    """Undo the input bit-depth reduction: shift back up and add the
    half-step so intensities stay centred (Tracker._quantize_inputs)."""
    shift = 8 - cfg.tracking.gray_wire_bits
    if shift <= 0:
        return gray
    return (gray << shift) + (1 << (shift - 1))


def _sample_depth(depth: torch.Tensor, xy: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Depth at rounded pixel coords (the reference samples the raw map,
    Frame.cc:1080). ``depth`` may be at a coarser resolution than the image
    (the tracker keeps half-res depth); coordinates are scaled to its grid."""
    h, w = depth.shape
    sx = w / hw[1]
    sy = h / hw[0]
    x = torch.round(xy[..., 0] * sx).to(torch.int64).clamp(0, w - 1)
    y = torch.round(xy[..., 1] * sy).to(torch.int64).clamp(0, h - 1)
    return depth[y, x]


def build_frame(gray: torch.Tensor, depth: torch.Tensor, cfg: SlamConfig,
                quantized: bool = False) -> FrameData:
    """FrameData of one RGB-D frame. ``gray`` is uint8 or float32 (0..255),
    ``depth`` integer (uint16 or int32: metres * depth_map_factor) or float32
    metres.
    ``quantized=True``: ``gray`` holds the tracker's reduced-bit gray
    (``TrackingConfig.gray_wire_bits``), restored here with a half step."""
    cam = cfg.camera
    hw = (cam.height, cam.width)
    if quantized:
        gray = _unquantize_gray(gray, cfg)
    if gray.dtype == torch.uint8:
        gray = gray.float()
    if not depth.is_floating_point():
        depth = depth.to(torch.float32) * float(1.0 / cfg.tracking.depth_map_factor)
    feats = orb.extract_orb(gray, cfg.orb)
    xy_un = projection.undistort_points(cam, feats.xy)
    d = _sample_depth(depth, feats.xy, hw)
    has_d = (d > 0) & feats.valid
    ur = torch.where(has_d, xy_un[:, 0] - cam.bf / torch.where(has_d, d, torch.ones_like(d)),
                     torch.full_like(d, -1.0))
    dev = gray.device
    nl = cfg.lines.max_lines
    if cfg.use_lines:
        lf = lsd.detect_lines(gray, cfg.lines, hw)
        gx, gy = image.sobel_gradients(image.gaussian_blur(gray.float(), 5, 1.0))
        ldesc = lbd.lbd_descriptors(gx, gy, lf.endpoints, lf.valid, cfg.lines)
        ep_un = projection.undistort_points(cam, lf.endpoints)
        ld = _sample_depth(depth, lf.endpoints, hw) * lf.valid[:, None]
        coeff = line_equation_2d(ep_un[:, 0], ep_un[:, 1])
        ln = dict(
            ln_ep=lf.endpoints, ln_ep_un=ep_un, ln_angle=lf.angle,
            ln_length=lf.length, ln_coeff=coeff, ln_desc=ldesc,
            ln_depth=ld, ln_valid=lf.valid,
        )
    else:
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        ln = dict(
            ln_ep=z(nl, 2, 2), ln_ep_un=z(nl, 2, 2), ln_angle=z(nl),
            ln_length=z(nl), ln_coeff=z(nl, 3),
            ln_desc=torch.zeros((nl, lbd.LBD_DIM), dtype=torch.uint8, device=dev),
            ln_depth=z(nl, 2), ln_valid=torch.zeros(nl, dtype=torch.bool, device=dev),
        )

    return FrameData(
        kp_xy=feats.xy,
        kp_xy_un=xy_un,
        kp_resp=feats.response,
        kp_octave=feats.octave,
        kp_angle=feats.angle,
        kp_desc=feats.desc,
        kp_depth=torch.where(has_d, d, torch.zeros_like(d)),
        kp_ur=ur,
        kp_valid=feats.valid,
        **ln,
    )
