"""The plain reference that decides ``correct``: plain PyTorch, written from
the published definitions, importing nothing of the program.

- the wire format's input reduction (6-bit gray, restored with a half step);
- the image pyramid (bilinear resize, half-pixel centres, level from level);
- FAST-9 corner scores with a 3x3 non-maximum suppression;
- ORB: per-cell keypoint selection with the threshold fallback, the global
  top-n, intensity-centroid angles, the 7x7 Gaussian blur and rotated BRIEF
  over OpenCV's 256-pair pattern (``orb_pattern.npy``, a frozen copy);
- the gated Hamming top-2 over 256-bit descriptors;
- ORB-SLAM2's point search by projection (ORBmatcher::SearchByProjection):
  the motion-model search from the last frame (window, scale band, rotation
  histogram, one query a target, a wider window when few match) and the
  local-map search (frustum, predicted level, ratio test, merged with the
  bindings the frame already has);
- the point+line pose-only Levenberg-Marquardt protocol (4 rounds of 10
  iterations, chi-square re-classification, Huber for the first two rounds).

Every function takes the precision it computes in, so the same code run in
the precision below the one the configuration states is the control.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy")).astype(np.float64)

# FAST's Bresenham circle of radius 3 in circular order, (dx, dy), y down
CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
          (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
ARC = 9
HALF_PATCH = 15
# chi-square gates of the pose problem: mono and stereo points, lines (two rows)
CHI2_MONO, CHI2_STEREO, CHI2_LINE = 5.991, 7.815, 2.0 * 7.815


# --------------------------------------------------------------- perception
def unquantize_gray(gray_u8: torch.Tensor, bits: int, dtype=torch.float32) -> torch.Tensor:
    """The gray the wire delivers: the top ``bits`` bits of the camera's
    uint8, restored with a half step."""
    shift = 8 - bits
    g = gray_u8.to(torch.int32)
    if shift > 0:
        g = ((g >> shift) << shift) + (1 << (shift - 1))
    return g.to(dtype)


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)]


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with half-pixel centres and no antialias: source
    coordinate (dst + 0.5) * in / out - 0.5, clamped at 0."""
    h, w = img.shape
    dt = img.dtype

    def axis(n_in, n_out):
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        src = (scale * (torch.arange(n_out, dtype=torch.float32) + 0.5) - 0.5).clamp(min=0)
        i0 = src.to(torch.int64)
        i1 = i0 + (i0 < n_in - 1).to(torch.int64)
        l1 = src - i0
        return i0.to(img.device), i1.to(img.device), l1.to(dt).to(img.device), \
            (1 - l1).to(dt).to(img.device)

    y0, y1, ly1, ly0 = axis(h, out_hw[0])
    x0, x1, lx1, lx0 = axis(w, out_hw[1])
    top = lx0 * img[y0][:, x0] + lx1 * img[y0][:, x1]
    bot = lx0 * img[y1][:, x0] + lx1 * img[y1][:, x1]
    return ly0[:, None] * top + ly1[:, None] * bot


def pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    shapes = pyramid_shapes(*img.shape, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def fast_score_nms(img: torch.Tensor, min_th: float) -> torch.Tensor:
    """FAST-9 score (the largest t for which 9 contiguous circle pixels are
    all brighter, or all darker, than the centre by more than t), zero at or
    below ``min_th`` and in the 3-pixel border, kept only where it is the
    maximum of its 3x3 neighbourhood."""
    h, w = img.shape
    c = img[3:h - 3, 3:w - 3]
    d = torch.stack([img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - c for dx, dy in CIRCLE])
    best = torch.full_like(c, -math.inf)
    for side in (d, -d):
        for k in range(16):
            arc = side[[(k + j) % 16 for j in range(ARC)]].amin(0)
            best = torch.maximum(best, arc)
    score = torch.zeros_like(img)
    score[3:h - 3, 3:w - 3] = torch.where(best > min_th, best, torch.zeros_like(best))
    pad = F.pad(score[None, None].float(), (1, 1, 1, 1), value=-math.inf)[0, 0]
    nb = torch.stack([pad[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).amax(0)
    return torch.where(score.float() >= nb, score, torch.zeros_like(score))


def level_budget(n_features: int, scale: float, n_levels: int) -> list[int]:
    """Features per level, in proportion to 1 / scale^l (ORB-SLAM2's
    ORBextractor constructor)."""
    f = 1.0 / scale
    n_desired = n_features * (1 - f) / (1 - f**n_levels)
    out = [int(round(n_desired * f**l)) for l in range(n_levels - 1)]
    out.append(max(n_features - sum(out), 0))
    return out


def _stable_desc(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting the last axis descending, lower index first on ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1]


def select_keypoints(score: torch.Tensor, ini_th: float, cell: int, per_cell: int,
                     border: int, n: int):
    """(ys, xs, resp) of the level's keypoints: in each cell the best
    ``per_cell`` scores above ``ini_th`` if any score there exceeds it, else
    above the low threshold already in ``score``; then the ``n`` best of all
    cells. Invalid rows have resp 0."""
    h, w = score.shape
    s = torch.zeros_like(score)
    s[border:h - border, border:w - border] = score[border:h - border, border:w - border]
    hp, wp = -(-h // cell) * cell, -(-w // cell) * cell
    s = F.pad(s, (0, wp - w, 0, hp - h))
    nch, ncw = hp // cell, wp // cell
    cells = s.reshape(nch, cell, ncw, cell).permute(0, 2, 1, 3).reshape(nch * ncw, cell * cell)
    cmax = cells.amax(-1, keepdim=True)
    th = torch.where(cmax > ini_th, torch.full_like(cmax, ini_th), torch.zeros_like(cmax))
    cells = torch.where(cells > th, cells, torch.zeros_like(cells))
    order = _stable_desc(cells)[:, :per_cell]
    vals = cells.gather(1, order)
    cid = torch.arange(nch * ncw, device=score.device)[:, None]
    ys = ((cid // ncw) * cell + order // cell).reshape(-1)
    xs = ((cid % ncw) * cell + order % cell).reshape(-1)
    vals = vals.reshape(-1)
    top = _stable_desc(vals)[:n]
    return ys[top], xs[top], vals[top]


def _umax() -> list[int]:
    """Half-widths of the rows of the radius-15 circular patch, built as
    OpenCV's ORB builds them (symmetric in the diagonal)."""
    umax = [0] * (HALF_PATCH + 2)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(HALF_PATCH * HALF_PATCH - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:HALF_PATCH + 1]


def ic_angles(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, dtype) -> torch.Tensor:
    """Intensity-centroid orientation in degrees [0, 360): atan2 of the
    patch's first moments m01, m10, summed directly over the circular patch
    (pixels outside the image count 0)."""
    h, w = img.shape
    umax = _umax()
    du, dv = [], []
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = umax[abs(v)]
        for u in range(-d, d + 1):
            du.append(u)
            dv.append(v)
    du = torch.tensor(du, device=img.device)
    dv = torch.tensor(dv, device=img.device)
    yy = ys.long()[:, None] + dv
    xx = xs.long()[:, None] + du
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    vals = img.reshape(-1)[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))].to(dtype)
    vals = torch.where(inside, vals, torch.zeros_like(vals))
    m10 = (vals * du.to(dtype)).sum(-1)
    m01 = (vals * dv.to(dtype)).sum(-1)
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian with reflect-101 borders (OpenCV's default)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k = torch.tensor(k / k.sum(), dtype=img.dtype, device=img.device)
    h, w = img.shape
    cols = torch.as_tensor(np.pad(np.arange(w), (r, r), mode="reflect"), device=img.device)
    rows = torch.as_tensor(np.pad(np.arange(h), (r, r), mode="reflect"), device=img.device)
    p = img[:, cols]
    out = sum(k[i] * p[:, i:i + w] for i in range(ksize))
    p = out[rows]
    return sum(k[i] * p[i:i + h] for i in range(ksize))


def brief(blurred: torch.Tensor, ys, xs, angles_deg, dtype) -> torch.Tensor:
    """Rotated-BRIEF descriptors (N, 32) uint8 in OpenCV's byte layout: bit
    b of byte j is set iff the blurred image at the rotated pattern point
    2(8j+b) is darker than at point 2(8j+b)+1; a point rotates to
    (round(x cos - y sin), round(x sin + y cos))."""
    h, w = blurred.shape
    theta = torch.deg2rad(angles_deg.to(dtype))
    a, b = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    pat = torch.as_tensor(PATTERN, dtype=dtype, device=blurred.device)
    rx = torch.round(pat[:, 0] * a - pat[:, 1] * b).long()
    ry = torch.round(pat[:, 0] * b + pat[:, 1] * a).long()
    yy = (ys.long()[:, None] + ry).clamp(0, h - 1)
    xx = (xs.long()[:, None] + rx).clamp(0, w - 1)
    v = blurred.reshape(-1)[yy * w + xx]
    bits = (v[:, 0::2] < v[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    return (bits << torch.arange(8, device=bits.device)).sum(-1).to(torch.uint8)


def orb(gray_u8: torch.Tensor, orb_cfg: dict, gray_bits: int, dtype=torch.float32):
    """Reference ORB of one camera frame: the wire's gray reduction, the
    pyramid, FAST, selection, angles and descriptors, all in ``dtype``.

    Returns (fast maps per level, keypoints dict of (N,) tensors: level, x,
    y (level pixels), resp, angle, desc (N, 32))."""
    img = unquantize_gray(gray_u8, gray_bits, dtype)
    levels = pyramid(img, orb_cfg["n_levels"], orb_cfg["scale_factor"])
    budget = level_budget(orb_cfg["n_features"], orb_cfg["scale_factor"], orb_cfg["n_levels"])
    maps, kp = [], {k: [] for k in ("level", "x", "y", "resp", "angle", "desc")}
    for l, lvl in enumerate(levels):
        s = fast_score_nms(lvl, float(orb_cfg["min_th_fast"]))
        maps.append(s)
        ys, xs, resp = select_keypoints(s, float(orb_cfg["ini_th_fast"]), orb_cfg["cell_size"],
                                        orb_cfg["max_kp_per_cell"], orb_cfg["edge_threshold"],
                                        budget[l])
        ok = resp > 0
        ys, xs, resp = ys[ok], xs[ok], resp[ok]
        ang = ic_angles(lvl, ys, xs, torch.float64 if dtype == torch.float32 else dtype)
        desc = brief(gaussian_blur(lvl), ys, xs, ang, dtype)
        for key, val in (("level", torch.full_like(ys, l)), ("x", xs), ("y", ys),
                         ("resp", resp), ("angle", ang), ("desc", desc)):
            kp[key].append(val)
    return maps, {k: torch.cat(v) for k, v in kp.items()}


# ----------------------------------------------------------------- matching
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming_top2(q: torch.Tensor, t: torch.Tensor, gate: torch.Tensor, dtype=torch.int32):
    """Best and second-best Hamming distance over each query's gated
    targets, and the best's index (the lowest on ties): q (N, 32), t (M, 32)
    uint8, gate (N, M) bool -> (best, idx, second) int64 (N,), with
    2^20 and -1 where nothing is gated. Distances are summed in ``dtype``."""
    big = 1 << 20
    n = q.shape[0]
    rows, cols = gate.nonzero(as_tuple=True)
    lut = _POPCOUNT.to(q.device)
    d = lut[(q[rows] ^ t[cols]).long()].to(dtype).sum(-1, dtype=dtype).long()
    best = torch.full((n,), big, dtype=torch.int64, device=q.device)
    best.scatter_reduce_(0, rows, d, "amin")
    at_best = d == best[rows]
    idx = torch.full((n,), 1 << 40, dtype=torch.int64, device=q.device)
    idx.scatter_reduce_(0, rows[at_best], cols[at_best], "amin")
    idx = torch.where(best < big, idx, torch.full_like(idx, -1))
    rest = cols != idx[rows]
    second = torch.full((n,), big, dtype=torch.int64, device=q.device)
    second.scatter_reduce_(0, rows[rest], d[rest], "amin")
    return best, idx, second


# ----------------------------------------------------------------- matching
# ORBmatcher's thresholds and the tracker's search radii for RGB-D
TH_HIGH = 100
HISTO_LENGTH = 30
MOTION_RADIUS = 15.0
LOCAL_RADIUS = 3.0
LOCAL_NN_RATIO = 0.9
NO_MATCH = -1


def project(cam, R, t, p, dtype):
    """(u, v, camera-frame points, in image) of world points p (n, 3) through
    the pose x_cam = R x + t, computed in ``dtype``."""
    pc = p.to(dtype) @ R.to(dtype).T + t.to(dtype)
    z = pc[:, 2]
    safe = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * pc[:, 0] / safe + cam.cx
    v = cam.fy * pc[:, 1] / safe + cam.cy
    in_img = (z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return u, v, pc, in_img


def window(u, v, xy_t, radius) -> torch.Tensor:
    """(Nq, Nt) gate: the target within the box of half-side ``radius``
    around the query's projection (Frame::GetFeaturesInArea)."""
    du = (u[:, None] - xy_t[None, :, 0].to(u.dtype)).abs()
    dv = (v[:, None] - xy_t[None, :, 1].to(v.dtype)).abs()
    return (du < radius[:, None]) & (dv < radius[:, None])


def rotation_filter(ok, idx, angle_q, angle_t, dtype) -> torch.Tensor:
    """``ok`` kept only where the match's angle difference falls in one of
    the histogram's three fullest bins, the second and third only if they
    hold a tenth of the first (ORBmatcher::ComputeThreeMaxima); the lower
    bin first on equal counts."""
    rot = angle_q.to(dtype) - angle_t.to(dtype)[idx.clamp(min=0)]
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = (rot / (360.0 / HISTO_LENGTH)).to(torch.int64).clamp(0, HISTO_LENGTH - 1)
    counts = torch.bincount(bins[ok], minlength=HISTO_LENGTH).tolist()
    order = sorted(range(HISTO_LENGTH), key=lambda i: (-counts[i], i))
    keep = [order[0]] + [i for i in order[1:3] if counts[i] >= 0.1 * counts[order[0]]]
    return ok & torch.isin(bins, torch.tensor(keep, device=bins.device))


def one_query_a_target(ok, idx, dist) -> torch.Tensor:
    """``ok`` kept for the one query of each target with the lowest
    distance, the lowest query on equal distances."""
    best: dict[int, tuple[int, int]] = {}
    for q, (o, j, d) in enumerate(zip(ok.tolist(), idx.tolist(), dist.tolist())):
        if o and (j not in best or (d, q) < best[j]):
            best[j] = (d, q)
    keep = torch.zeros_like(ok)
    keep[[q for _, q in best.values()]] = True
    return keep


def search_motion(cam, scale, fd: dict, q: dict, R, t, dtype=torch.float64,
                  dist_dtype=torch.int32) -> torch.Tensor:
    """The target of each query (the last frame's points, world positions
    ``q["p3d"]``) in the frame ``fd`` seen from the motion model's pose, or
    -1: a window of 15 px times the query's scale around its projection,
    targets an octave below to an octave above it, the best distance at most
    ``TH_HIGH``, the rotation histogram, one query a target; the window
    doubled where fewer than 20 match (Tracking::TrackWithMotionModel)."""
    u, v, _, in_img = project(cam, R, t, q["p3d"], dtype)
    q_ok = q["valid"] & in_img
    d_oct = fd["octave"][None, :].long() - q["octave"][:, None].long()
    base = (d_oct >= -1) & (d_oct <= 1) & q_ok[:, None] & fd["valid"][None, :]
    for mult in (1.0, 2.0):
        radius = MOTION_RADIUS * mult * scale ** q["octave"].to(dtype)
        gate = base & window(u, v, fd["xy"], radius)
        best, idx, _ = hamming_top2(q["desc"], fd["desc"], gate, dist_dtype)
        ok = best <= TH_HIGH
        ok = rotation_filter(ok, idx, q["angle"], fd["angle"], dtype)
        ok = one_query_a_target(ok, idx, best)
        if int(ok.sum()) >= 20:
            break
    return torch.where(ok, idx, torch.full_like(idx, NO_MATCH))


def search_local(cam, scale, n_levels, fd: dict, lm: dict, R, t, dtype=torch.float64,
                 dist_dtype=torch.int32) -> torch.Tensor:
    """The target of each local-map point in the frame ``fd`` at the pose
    (R, t), or -1 (Tracking::SearchLocalPoints): points in the frustum
    (in the image, within 0.8-1.2 of their distance band, seen within 60
    degrees of their normal) are searched in a window of 3 px times 2.5
    (nearly head-on) or 4, times the scale of the level their distance
    predicts, among targets of that level or one below; the best distance at
    most ``TH_HIGH`` and under 0.9 of the second; one point a target. The
    frame's bindings from the motion step (``lm["pre"]``) fill in where the
    search found nothing, and one point a target is enforced again, the
    search's matches first on equal distances."""
    u, v, _, in_img = project(cam, R, t, lm["p3d"], dtype)
    Rd, td = R.to(dtype), t.to(dtype)
    centre = -(Rd.T @ td)
    po = lm["p3d"].to(dtype) - centre
    dist = torch.linalg.vector_norm(po, dim=-1)
    normal = lm["normal"].to(dtype)
    mind, maxd = lm["mind"].to(dtype), lm["maxd"].to(dtype)
    view_cos = (po * normal).sum(-1) / (dist * torch.linalg.vector_norm(normal, dim=-1)
                                        ).clamp(min=1e-6)
    visible = (lm["valid"] & in_img & (dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
               & (view_cos > 0.5))
    ratio = torch.log(maxd.clamp(min=1e-6) / dist.clamp(min=1e-6))
    level = torch.ceil(ratio / math.log(scale)).to(torch.int64).clamp(0, n_levels - 1)
    radius = LOCAL_RADIUS * torch.where(view_cos > 0.998, 2.5, 4.0) * scale ** level.to(dtype)
    d_oct = fd["octave"][None, :].long() - level[:, None]
    gate = (window(u, v, fd["xy"], radius) & (d_oct >= -1) & (d_oct <= 0)
            & visible[:, None] & fd["valid"][None, :])
    best, idx, second = hamming_top2(lm["desc"], fd["desc"], gate, dist_dtype)
    ok = (best <= TH_HIGH) & (best.double() < LOCAL_NN_RATIO * second.double())
    ok = one_query_a_target(ok, idx, best)
    pre = lm["pre"].long()
    idx = torch.where(ok, idx, pre)
    dist_ = torch.where(ok, best, torch.full_like(best, 300))
    ok = one_query_a_target(ok | (pre >= 0), idx, dist_)
    return torch.where(ok, idx, torch.full_like(idx, NO_MATCH))


# ------------------------------------------------------------------ pose LM
def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """exp of [omega, upsilon] -> (R, t = V upsilon)."""
    w, u = xi[:3], xi[3:]
    th2 = (w * w).sum()
    th = torch.sqrt(th2)
    if float(th2) > 1e-12:
        a, b, c = torch.sin(th) / th, (1 - torch.cos(th)) / th2, (th - torch.sin(th)) / (th2 * th)
    else:
        a, b, c = 1 - th2 / 6, 0.5 - th2 / 24, 1.0 / 6 - th2 / 120
    W = _hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    return eye + a * W + b * (W @ W), (eye + b * W + c * (W @ W)) @ u


def _orthonormalize(R):
    for _ in range(2):
        R = 0.5 * (3.0 * R - R @ (R.T @ R))
    return R


def pose_lm(cam, R0, t0, obs: dict, rounds: int = 4, iters: int = 10, dtype=torch.float64):
    """The pose-only problem solved by the reference protocol, in ``dtype``.

    ``obs``: p3d (N, 3) world points, uv (N, 2) observed pixels, u_right (N,)
    (-1 without depth), inv_sigma2 (N,), valid (N,); line_nw, line_vw (L, 3)
    world Plücker moment and direction, line_uv (L, 2, 2) observed
    endpoints, line_inv_sigma2 (L,), line_valid (L,). Point rows: (u, v) and,
    with depth, the virtual right u = u - bf / z; line rows: both endpoints'
    signed distances to the projected line. 4 rounds of 10 damped
    Gauss-Newton steps on the left update exp(xi) o (R, t) (a step is kept
    if it lowers the cost; damping x0.5 on a kept step, x4 otherwise); each
    round starts from the inliers the previous one classified by chi-square
    at its pose; Huber weights in rounds 0-1. The Jacobian is taken by
    central differences in float64 (~1e-9 relative, far below what the
    comparison reads). Returns (R, t)."""
    dev = R0.device
    f = {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev)) for k, v in obs.items()}
    f64 = {k: (v.to(dev, torch.float64) if v.is_floating_point() else v.to(dev))
           for k, v in obs.items()}
    fx, fy, cx, cy, bf = (float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy", "bf"))
    stereo = f["u_right"] >= 0
    d2_pt = torch.where(stereo, torch.full_like(f["u_right"], CHI2_STEREO),
                        torch.full_like(f["u_right"], CHI2_MONO))

    def residuals(R, t, f):
        """(point rows (N, 3): u, v, right u (0 without depth); line rows
        (L, 2); behind the camera (N,))."""
        dt = R.dtype
        K_line = torch.tensor([[fy, 0, 0], [0, fx, 0], [-fy * cx, -fx * cy, fx * fy]],
                              dtype=dt, device=dev)
        pc = f["p3d"] @ R.T + t
        z = pc[:, 2]
        zs = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        r_ur = torch.where(f["u_right"] >= 0, u - bf / zs - f["u_right"], torch.zeros_like(u))
        r_pt = torch.stack([u - f["uv"][:, 0], v - f["uv"][:, 1], r_ur], -1)
        n_c = f["line_nw"] @ R.T + torch.linalg.cross(t.expand_as(f["line_vw"]),
                                                      f["line_vw"] @ R.T, dim=-1)
        l = n_c @ K_line.T
        nrm = torch.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2 + 1e-12)
        r_l = torch.stack([(l[:, 0] * f["line_uv"][:, k, 0] + l[:, 1] * f["line_uv"][:, k, 1]
                            + l[:, 2]) / nrm for k in (0, 1)], -1)
        return r_pt, r_l, z <= 1e-6

    def chi2(R, t):
        r_pt, r_l, behind = residuals(R, t, f)
        c_pt = (r_pt ** 2).sum(-1) * f["inv_sigma2"]
        c_pt = torch.where(behind, torch.full_like(c_pt, math.inf), c_pt)
        return c_pt, (r_l ** 2).sum(-1) * f["line_inv_sigma2"]

    def rho(c, d2):
        return torch.where(c > d2, 2 * torch.sqrt(d2 * c.clamp(min=0)) - d2, c)

    def cost(R, t, m_pt, m_ln, robust):
        c_pt, c_ln = chi2(R, t)
        c_pt = torch.where(torch.isfinite(c_pt), c_pt, torch.full_like(c_pt, 1e9))
        if robust:
            c_pt, c_ln = rho(c_pt, d2_pt), rho(c_ln, torch.full_like(c_ln, CHI2_LINE))
        return (c_pt * m_pt).sum() + (c_ln * m_ln).sum()

    def rows(R, t, f):
        r_pt, r_l, _ = residuals(R, t, f)
        return torch.cat([r_pt.reshape(-1), r_l.reshape(-1)])

    def jacobian(R, t):
        R, t = R.double(), t.double()
        cols = []
        for k in range(6):
            xi = torch.zeros(6, dtype=torch.float64, device=dev)
            xi[k] = 1e-6
            Rp, tp = se3_exp(xi)
            Rm, tm = se3_exp(-xi)
            cols.append((rows(Rp @ R, Rp @ t + tp, f64) - rows(Rm @ R, Rm @ t + tm, f64)) / 2e-6)
        return torch.stack(cols, -1).to(dtype)

    def weights(R, t, m_pt, m_ln, robust):
        c_pt, c_ln = chi2(R, t)
        w_pt, w_ln = torch.ones_like(c_pt), torch.ones_like(c_ln)
        if robust:
            w_pt = torch.where(c_pt <= d2_pt, w_pt, torch.sqrt(d2_pt / c_pt.clamp(min=1e-12)))
            w_ln = torch.where(c_ln <= CHI2_LINE, w_ln,
                               torch.sqrt(CHI2_LINE / c_ln.clamp(min=1e-12)))
        w_pt = w_pt * f["inv_sigma2"] * m_pt
        w_ln = w_ln * f["line_inv_sigma2"] * m_ln
        return torch.cat([w_pt.repeat_interleave(3), w_ln.repeat_interleave(2)])

    R = _orthonormalize(R0.to(dev, dtype))
    t = t0.to(dev, dtype)
    in_pt, in_ln = f["valid"].clone(), f["line_valid"].clone()
    eye = torch.eye(6, dtype=torch.float64, device=dev)
    for r in range(rounds):
        robust = r < 2
        m_pt = (in_pt & f["valid"]).to(dtype)
        m_ln = (in_ln & f["line_valid"]).to(dtype)
        lam = 1e-5
        for _ in range(iters):
            J = jacobian(R, t)
            w = weights(R, t, m_pt, m_ln, robust)
            H = J.T @ (J * w[:, None])
            b = -(J.T @ (w * rows(R, t, f)))
            H, b = H.double(), b.double()
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            dR, dt = se3_exp(torch.linalg.solve(Hd, b).to(dtype))
            Rn, tn = dR @ R, dR @ t + dt
            if bool(cost(Rn, tn, m_pt, m_ln, robust) < cost(R, t, m_pt, m_ln, robust)) \
                    and bool(torch.isfinite(tn).all()):
                R, t, lam = Rn, tn, max(lam * 0.5, 1e-9)
            else:
                lam = min(lam * 4.0, 1e6)
        c_pt, c_ln = chi2(R, t)
        in_pt = (c_pt <= d2_pt) & f["valid"]
        in_ln = (c_ln <= CHI2_LINE) & f["line_valid"]
        R = _orthonormalize(R)
    return R, t
