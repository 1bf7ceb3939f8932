"""Per-frame perception: from (gray, depth) or a stereo pair to FrameData.

The reference ``Frame`` RGB-D constructor (Frame.cc:97-205): ORB and line
extraction (two pthreads there, :152-155; one stream of device work here),
depth association following ``ComputeStereoFromRGBD`` (:1065-1117): the
virtual-right coordinate u_r = u - bf/d for keypoints, endpoint depths for
keylines, and undistortion following ``UndistortKeyPoints/KeyLines``
(:737-845). Windowed searches use dense gate matrices, so the reference's
64x48 keypoint grid is not built.

The stereo constructor (Frame.cc:88-133, ``build_frame_stereo``) runs ORB
on both images and matches left to right (``ComputeStereoMatches``,
:888-1062) as one gated descriptor search and one gathered SAD strip.

Both constructors take optional leading batch axes on their images (B
sequences tracked in one step); every FrameData field then has them too.
An unbatched call runs the same operations without them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..geometry import projection
from ..geometry.lines import line_equation_2d
from ..ops import image, lbd, lsd, orb
from ..ops.batch import pixels_at


class FrameData(NamedTuple):
    """All per-frame arrays (fixed capacity, mask-padded); a batch of frames
    has its leading axes in front of every field."""

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
    (the tracker keeps half-res depth); coordinates are scaled to its grid.
    ``depth`` (..., h, w), ``xy`` (..., *S, 2)."""
    h, w = depth.shape[-2:]
    sx = w / hw[1]
    sy = h / hw[0]
    x = torch.round(xy[..., 0] * sx).to(torch.int64).clamp(0, w - 1)
    y = torch.round(xy[..., 1] * sy).to(torch.int64).clamp(0, h - 1)
    return pixels_at(depth, y * w + x)


def build_frame(gray: torch.Tensor, depth: torch.Tensor, cfg: SlamConfig,
                quantized: bool = False) -> FrameData:
    """FrameData of one RGB-D frame, or of a batch of frames (``gray``
    (..., H, W), ``depth`` (..., h, w)). ``gray`` is uint8 or float32
    (0..255), ``depth`` integer (uint16 or int32: metres * depth_map_factor)
    or float32 metres.
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
    ur = torch.where(has_d, xy_un[..., 0] - cam.bf / torch.where(has_d, d, torch.ones_like(d)),
                     torch.full_like(d, -1.0))
    dev = gray.device
    lead = gray.shape[:-2]
    nl = cfg.lines.max_lines
    if cfg.use_lines:
        lf = lsd.detect_lines(gray, cfg.lines, hw)
        gx, gy = image.sobel_gradients(image.gaussian_blur(gray.float(), 5, 1.0))
        ldesc = lbd.lbd_descriptors(gx, gy, lf.endpoints, lf.valid, cfg.lines)
        ep_un = projection.undistort_points(cam, lf.endpoints)
        ld = _sample_depth(depth, lf.endpoints, hw) * lf.valid[..., None]
        coeff = line_equation_2d(ep_un[..., 0, :], ep_un[..., 1, :])
        ln = dict(
            ln_ep=lf.endpoints, ln_ep_un=ep_un, ln_angle=lf.angle,
            ln_length=lf.length, ln_coeff=coeff, ln_desc=ldesc,
            ln_depth=ld, ln_valid=lf.valid,
        )
    else:
        ln = _no_lines(lead, nl, dev)

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


def _no_lines(lead: tuple, nl: int, dev) -> dict:
    """The line fields of a frame without lines (all padding)."""
    z = lambda *s: torch.zeros(lead + s, dtype=torch.float32, device=dev)  # noqa: E731
    return dict(
        ln_ep=z(nl, 2, 2), ln_ep_un=z(nl, 2, 2), ln_angle=z(nl),
        ln_length=z(nl), ln_coeff=z(nl, 3),
        ln_desc=torch.zeros(lead + (nl, lbd.LBD_DIM), dtype=torch.uint8, device=dev),
        ln_depth=z(nl, 2), ln_valid=torch.zeros(lead + (nl,), dtype=torch.bool, device=dev),
    )


def backproject_keypoints(cam, fd: FrameData) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame 3D of the keypoints with depth (UnprojectStereo,
    Frame.cc:1124-1140). Returns (p3d (N, 3), ok (N,))."""
    ok = fd.kp_valid & (fd.kp_depth > 0)
    return projection.backproject(cam, fd.kp_xy_un, fd.kp_depth), ok


def backproject_lines(cam, fd: FrameData) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame 3D endpoints of the keylines with both depths
    (UnprojectStereoLineStart/End, with the reference's read of the wrong
    array at Frame.cc:1192 fixed, as the JAX package does).
    Returns (ep3d (NL, 2, 3), ok (NL,))."""
    ok = fd.ln_valid & (fd.ln_depth[..., 0] > 0) & (fd.ln_depth[..., 1] > 0)
    p0 = projection.backproject(cam, fd.ln_ep_un[..., 0, :], fd.ln_depth[..., 0])
    p1 = projection.backproject(cam, fd.ln_ep_un[..., 1, :], fd.ln_depth[..., 1])
    return torch.stack([p0, p1], -2), ok


SAD_W = 5  # 11x11 SAD window (Frame.cc:986)
SAD_L = 5  # +-5 px search around the descriptor match


def build_frame_stereo(gray_l: torch.Tensor, gray_r: torch.Tensor, cfg: SlamConfig,
                       quantized: bool = False) -> FrameData:
    """FrameData of one rectified stereo pair (uint8 or float32 0..255), or
    of a batch of pairs (..., H, W): ORB on both images, a row-band descriptor match left to right, a SAD
    refinement of the disparity with a parabola fit, depth = bf / disparity.
    The stereo constructor extracts no lines, so the line block is empty.

    The reference's per-row candidate buckets become one (N_L, N_R) gate
    (row band 2 * sigma(octave_L), disparity in (0, fx), octaves within
    one) into ``matching.match_descriptors`` (the Hamming kernel on the
    card); the sliding 11x11 SAD over +-5 px is one gathered (N, 11, 11, 11)
    strip. ``quantized=True``: both images hold the tracker's reduced-bit
    gray, restored here with a half step."""
    from ..ops import matching

    cam = cfg.camera
    hw = (cam.height, cam.width)
    if quantized:
        gray_l = _unquantize_gray(gray_l, cfg)
        gray_r = _unquantize_gray(gray_r, cfg)
    gl = gray_l.float()
    gr = gray_r.float()
    fl = orb.extract_orb(gl, cfg.orb)
    fr = orb.extract_orb(gr, cfg.orb)
    dev = gl.device
    lead = gl.shape[:-2]

    max_d = cam.fx  # disparity upper bound (maxD, Frame.cc:905)
    # row band |vL - vR| <= 2 * sigma(octave_L) (Frame.cc:930-940)
    band = 2.0 * cfg.orb.scale_factor ** fl.octave.float()
    dv = (fl.xy[..., :, None, 1] - fr.xy[..., None, :, 1]).abs()
    disp = fl.xy[..., :, None, 0] - fr.xy[..., None, :, 0]
    gate = ((dv <= band[..., :, None]) & (disp > 0.0) & (disp < max_d)
            & fl.valid[..., :, None] & fr.valid[..., None, :]
            & ((fl.octave[..., :, None] - fr.octave[..., None, :]).abs() <= 1))
    m = matching.match_descriptors(fl.desc, fr.desc, gate, 100)
    u_r0 = fr.xy[..., 0].gather(-1, m.idx.long().clamp(0, fr.xy.shape[-2] - 1))

    # SAD refinement (Frame.cc:986-1050): mean-normalised 11x11 windows,
    # the right one slid over +-L px, gathered in one indexed read
    W, L = SAD_W, SAD_L
    w_img = hw[1]
    ys = torch.round(fl.xy[..., 1]).long().clamp(W, hw[0] - W - 1)
    xl = torch.round(fl.xy[..., 0]).long().clamp(W + L, hw[1] - W - L - 1)
    xr = torch.round(u_r0).long().clamp(W + L, hw[1] - W - L - 1)
    r = torch.arange(-W, W + 1, device=dev)
    dy, dx = r[:, None], r[None, :]
    patch_l = pixels_at(gl, (ys[..., None, None] + dy) * w_img
                        + xl[..., None, None] + dx)                        # (..., N, 11, 11)
    offs = torch.arange(-L, L + 1, device=dev)[:, None, None]
    strips = pixels_at(gr, (ys[..., None, None, None] + dy) * w_img
                       + xr[..., None, None, None] + offs + dx)            # (..., N, 2L+1, 11, 11)
    pl = patch_l - patch_l.mean((-2, -1), keepdim=True)
    ps = strips - strips.mean((-2, -1), keepdim=True)
    sad = (ps - pl[..., None, :, :]).abs().sum((-2, -1))                  # (..., N, 2L+1)
    best = torch.argmin(sad, -1)  # the first minimum, as jnp.argmin
    # parabola subpixel fit (Frame.cc:1030-1043)
    bi = best.clamp(1, 2 * L - 1)
    s0 = sad.gather(-1, (bi - 1)[..., None])[..., 0]
    s1 = sad.gather(-1, bi[..., None])[..., 0]
    s2 = sad.gather(-1, (bi + 1)[..., None])[..., 0]
    denom = (s0 + s2 - 2 * s1).clamp(min=1e-6)
    delta = ((s0 - s2) / (2 * denom)).clamp(-1.0, 1.0)
    u_r = xr.float() + (bi - L).float() + delta

    disparity = fl.xy[..., 0] - u_r
    ok = m.ok & (disparity > 0.01) & (disparity < max_d)
    zero = torch.zeros_like(disparity)
    depth = torch.where(ok, cam.bf / disparity.clamp(min=1e-6), zero)
    xy_un = projection.undistort_points(cam, fl.xy)
    ur = torch.where(ok, xy_un[..., 0] - cam.bf / depth.clamp(min=1e-6), zero - 1.0)

    return FrameData(
        kp_xy=fl.xy, kp_xy_un=xy_un, kp_resp=fl.response, kp_octave=fl.octave,
        kp_angle=fl.angle, kp_desc=fl.desc, kp_depth=depth, kp_ur=ur, kp_valid=fl.valid,
        **_no_lines(lead, cfg.lines.max_lines, dev),
    )
