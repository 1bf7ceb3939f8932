"""2D/3D line geometry: Plücker coordinates, projection, clipping.

The line math of the reference fork, batched on torch tensors:

- Plücker coords ``n = s × e, v = e − s`` from endpoints
  (``MapLine.cpp:38-41``),
- projection of a camera-frame Plücker line to an image line via the
  "line intrinsics" matrix (``types_line_expmap.h:77-104``),
- endpoint-to-line signed distance residual,
- Liang–Barsky segment clipping against the image rectangle
  (``LineMatcher.cpp:1389-1460``),
- 1D overlap of segment projections (``LineMatcher.cpp:1508-1559``).
"""

from __future__ import annotations

import torch

from . import se3


def plucker_from_endpoints(p_start: torch.Tensor, p_end: torch.Tensor):
    """Endpoints (..., 3) -> Plücker (n, v): n = s×e (moment), v = e−s (dir)."""
    n = torch.linalg.cross(p_start, p_end, dim=-1)
    v = p_end - p_start
    return n, v


def transform_plucker(R, t, n, v):
    """World Plücker (..., N, 3) -> camera Plücker under x_cam = R x + t
    (R (..., 3, 3), t (..., 3): one pose, or one per batch entry):
    n' = R n + [t]ₓ R v ;  v' = R v."""
    Rv = se3.rotate(R, v)
    Rn = se3.rotate(R, n)
    n_c = Rn + torch.linalg.cross(t[..., None, :].expand(Rv.shape), Rv, dim=-1)
    return n_c, Rv


def line_intrinsics(fx, fy, cx, cy, device=None) -> torch.Tensor:
    """K_line such that image line l = K_line @ n_cam
    (types_line_expmap.h:87-95)."""
    return torch.tensor(
        [[fy, 0.0, 0.0], [0.0, fx, 0.0], [-fy * cx, -fx * cy, fx * fy]],
        dtype=torch.float32, device=device,
    )


def project_plucker(K_line: torch.Tensor, n_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame Plücker moments (..., N, 3) -> homogeneous image lines
    (..., N, 3)."""
    return se3.rotate(K_line, n_cam)


def point_line_distance(l: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Signed distance of pixel (..., 2) to homogeneous line (..., 3)."""
    denom = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2 + 1e-12)
    return (l[..., 0] * uv[..., 0] + l[..., 1] * uv[..., 1] + l[..., 2]) / denom


def line_equation_2d(e0: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    """Normalized homogeneous 2D line through two endpoints (..., 2) — the
    reference's cross-product of homogeneous endpoints
    (LineExtractor.cpp:60-69)."""
    one = torch.ones_like(e0[..., 0])
    a = torch.stack([e0[..., 0], e0[..., 1], one], -1)
    b = torch.stack([e1[..., 0], e1[..., 1], one], -1)
    l = torch.linalg.cross(a, b, dim=-1)
    norm = torch.linalg.vector_norm(l, dim=-1, keepdim=True)
    return l / torch.where(norm > 1e-12, norm, torch.ones_like(norm))


def liang_barsky(p0: torch.Tensor, p1: torch.Tensor, xmin, ymin, xmax, ymax):
    """Clip segments p0->p1 ((..., 2) each) to rect. Returns (q0, q1, valid).

    Branch-free Liang–Barsky: t-range intersection over the four edges.
    """
    d = p1 - p0
    p = torch.stack([-d[..., 0], d[..., 0], -d[..., 1], d[..., 1]], -1)
    q = torch.stack(
        [p0[..., 0] - xmin, xmax - p0[..., 0], p0[..., 1] - ymin, ymax - p0[..., 1]],
        -1,
    )
    r = q / torch.where(p.abs() > 1e-12, p, torch.full_like(p, 1e-12))
    # For p<0 edge contributes to t_enter; p>0 to t_exit; p==0: reject if q<0.
    neg = p < -1e-12
    pos = p > 1e-12
    t0 = torch.where(neg, r, torch.zeros_like(r)).amax(-1)
    t1 = torch.where(pos, r, torch.ones_like(r)).amin(-1)
    parallel_out = ((p.abs() <= 1e-12) & (q < 0.0)).any(-1)
    valid = (t0 <= t1) & ~parallel_out
    q0 = p0 + t0[..., None] * d
    q1 = p0 + t1[..., None] * d
    return q0, q1, valid


def segment_overlap(a0, a1, b0, b1):
    """1D overlap ratio of projections — reference LineOverLap
    (LineMatcher.cpp:1508-1559): overlap length / shorter extent."""
    lo = torch.maximum(torch.minimum(a0, a1), torch.minimum(b0, b1))
    hi = torch.minimum(torch.maximum(a0, a1), torch.maximum(b0, b1))
    inter = (hi - lo).clamp(min=0.0)
    len_a = (a1 - a0).abs()
    len_b = (b1 - b0).abs()
    shorter = torch.minimum(len_a, len_b)
    return inter / torch.where(shorter > 1e-6, shorter, torch.full_like(shorter, 1e-6))
