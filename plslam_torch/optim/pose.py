"""Pose-only optimization: joint point + line Levenberg–Marquardt.

Replaces the reference's g2o problems ``Optimizer::PoseOptimization``
(Optimizer.cc:375-643) and ``Optimizer::PoseOptimizationWithLines``
(:2132-2489):

- mono point edges   (EdgeSE3ProjectXYZOnlyPose,      chi2 gate 5.991)
- stereo point edges (EdgeStereoSE3ProjectXYZOnlyPose, chi2 gate 7.815)
- line edges         (EdgeLineOnlyPose — both observed endpoints' signed
  distances to the projected infinite Plücker line; types_line_expmap.h:
  77-104; outlier if chi2 > 2*7.815, Optimizer.cc:2459)

Reference protocol: 4 rounds x 10 LM iterations; after each round
observations are re-classified inlier/outlier by chi2 at the current pose;
Huber kernels (delta = sqrt(gate)) active for the first two rounds only.
Jacobians are analytic, for the left perturbation exp(xi) ∘ (R, t) at
xi = 0 (the derivative the JAX package takes with forward-mode autodiff):
a camera-frame point moves by omega × p + upsilon and a camera-frame
Plücker moment by omega × n + upsilon × v. The loop has no host
synchronisation: every accept/reject is a ``torch.where`` on device
tensors.

Optional leading batch axes on the pose and the observations optimise B
independent problems at once (B sequences tracked in one step): (B, 6, 6)
normal equations, each problem with its own damping, acceptance and robust
kernel state. An unbatched call runs the same operations without them. The
normal equations' long sums, the costs an LM step compares and the 6x6
solves run one problem at a time (``ops.batch.each``: seven calls an
iteration take B launches each), so that a problem in a batch gets the bits
it gets alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lines as glines
from ..geometry import se3
from ..ops.batch import each

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
CHI2_LINE = 2.0 * 7.815


class PoseObs(NamedTuple):
    """Fixed-capacity observation set for pose-only optimization (with the
    batch's leading axes in front of every field)."""

    # points (N,)
    p3d: torch.Tensor          # (N, 3) world positions
    uv: torch.Tensor           # (N, 2) observed undistorted pixels
    u_right: torch.Tensor      # (N,) virtual right u (stereo/RGB-D) or -1 (mono)
    inv_sigma2: torch.Tensor   # (N,) information scale (1/sigma^2 of octave)
    valid: torch.Tensor        # (N,) bool
    # lines (NL,)
    line_nw: torch.Tensor      # (NL, 3) world Plücker moment
    line_vw: torch.Tensor      # (NL, 3) world Plücker direction
    line_uv: torch.Tensor      # (NL, 2, 2) observed endpoints (undistorted px)
    line_inv_sigma2: torch.Tensor  # (NL,)
    line_valid: torch.Tensor   # (NL,) bool


class PoseResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier_pts: torch.Tensor    # (N,) bool — final point inliers
    inlier_lines: torch.Tensor  # (NL,) bool
    n_inliers: torch.Tensor     # scalar int32 — point inliers


def _point_residuals(cam, R, t, obs: PoseObs):
    """(r_uv (N,2), r_ur (N,), behind (N,)). Stereo rows active where
    u_right >= 0."""
    pc = se3.apply(R, t, obs.p3d)
    z = pc[..., 2]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    r_uv = torch.stack([u - obs.uv[..., 0], v - obs.uv[..., 1]], -1)
    ur = u - cam.bf / safe_z
    r_ur = torch.where(obs.u_right >= 0, ur - obs.u_right, torch.zeros_like(ur))
    return r_uv, r_ur, z <= 1e-6


def _line_residuals(cam, R, t, obs: PoseObs, K_line):
    """Signed distances of both observed endpoints to the projected line."""
    n_c, _ = glines.transform_plucker(R, t, obs.line_nw, obs.line_vw)
    l = glines.project_plucker(K_line, n_c)  # (NL, 3)
    d0 = glines.point_line_distance(l, obs.line_uv[..., 0, :])
    d1 = glines.point_line_distance(l, obs.line_uv[..., 1, :])
    return torch.stack([d0, d1], -1)  # (NL, 2)


def _jacobians(cam, R, t, obs: PoseObs, K_line):
    """Jacobians (rows, 6) of the point residuals r_uv (N,2), r_ur (N,) and
    the line residuals (NL,2) w.r.t. the left perturbation xi = [omega,
    upsilon] of (R, t). Where the point depth was clamped (|z| <= 1e-6) the
    clamp has no depth derivative, as in the JAX package's autodiff."""
    pc = se3.apply(R, t, obs.p3d)
    x, y, z = pc.unbind(-1)
    ok_z = z.abs() > 1e-6
    iz = 1.0 / torch.where(ok_z, z, torch.full_like(z, 1e-6))
    zero = torch.zeros_like(z)
    iz2 = torch.where(ok_z, iz * iz, zero)
    du = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    dv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)
    dur = torch.where((obs.u_right >= 0)[..., None],
                      du + torch.stack([zero, zero, cam.bf * iz2], -1),
                      torch.zeros_like(du))

    def point_rows(g):  # d/dxi of a function with gradient g w.r.t. pc
        return torch.cat([torch.linalg.cross(pc, g, dim=-1), g], -1)

    n_c, v_c = glines.transform_plucker(R, t, obs.line_nw, obs.line_vw)
    l = glines.project_plucker(K_line, n_c)  # (NL, 3)
    s = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2 + 1e-12)
    s3 = s * s * s
    j_rows = []
    for k in (0, 1):
        pu, pv = obs.line_uv[..., k, 0], obs.line_uv[..., k, 1]
        num = l[..., 0] * pu + l[..., 1] * pv + l[..., 2]
        dl = torch.stack([pu / s - num * l[..., 0] / s3, pv / s - num * l[..., 1] / s3,
                          1.0 / s], -1)
        gn = se3.rotate(K_line.mT, dl)  # gradient w.r.t. the camera-frame moment
        j_rows.append(torch.cat([torch.linalg.cross(n_c, gn, dim=-1),
                                 torch.linalg.cross(v_c, gn, dim=-1)], -1))
    return (torch.stack([point_rows(du), point_rows(dv)], -2), point_rows(dur),
            torch.stack(j_rows, -2))


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b)[0]


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    return x.sum(-1)


def _huber_w(chi2, delta2):
    """IRLS weight of the Huber kernel on squared error."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / chi2.clamp(min=1e-12)))


def optimize_pose(cam, R0: torch.Tensor, t0: torch.Tensor, obs: PoseObs,
                  rounds: int = 4, iters: int = 10) -> PoseResult:
    """Reference-protocol pose optimization (see module docstring); R0
    (..., 3, 3), t0 (..., 3) and the observations share the leading axes."""
    dev = R0.device
    lead = R0.shape[:-2]
    K_line = glines.line_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, device=dev)
    stereo = obs.u_right >= 0
    delta2_pt = torch.where(stereo, torch.full_like(obs.u_right, CHI2_STEREO),
                            torch.full_like(obs.u_right, CHI2_MONO))
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def chi2(R, t):
        r_uv, r_ur, behind = _point_residuals(cam, R, t, obs)
        chi_pt = ((r_uv**2).sum(-1) + r_ur**2) * obs.inv_sigma2
        chi_pt = torch.where(behind, torch.full_like(chi_pt, float("inf")), chi_pt)
        r_l = _line_residuals(cam, R, t, obs, K_line)
        return chi_pt, (r_l**2).sum(-1) * obs.line_inv_sigma2

    def build_normal_eqs(R, t, w_pt_mask, w_ln_mask, robust):
        r_uv, r_ur, _ = _point_residuals(cam, R, t, obs)
        r_l = _line_residuals(cam, R, t, obs, K_line)
        J_uv, J_ur, J_l = _jacobians(cam, R, t, obs, K_line)
        chi_pt = ((r_uv**2).sum(-1) + r_ur**2) * obs.inv_sigma2
        chi_ln = (r_l**2).sum(-1) * obs.line_inv_sigma2
        if robust:
            w_pt = _huber_w(chi_pt, delta2_pt)
            w_ln = _huber_w(chi_ln, torch.full_like(chi_ln, CHI2_LINE))
        else:
            w_pt = torch.ones_like(chi_pt)
            w_ln = torch.ones_like(chi_ln)
        w_pt = w_pt * obs.inv_sigma2 * w_pt_mask
        w_ln = w_ln * obs.line_inv_sigma2 * w_ln_mask

        # H = sum w J^T J over residual rows; b = -sum w J^T r
        def acc(J, r, w):
            JwT = (J * w[..., None]).reshape(lead + (-1, 6)).mT
            return (each(torch.mm, lead, JwT, J.reshape(lead + (-1, 6))),
                    -each(torch.mv, lead, JwT, r.reshape(lead + (-1,))))

        H1, b1 = acc(J_uv, r_uv, w_pt[..., None])
        H2, b2 = acc(J_ur, r_ur, w_pt)
        H3, b3 = acc(J_l, r_l, w_ln[..., None])
        return H1 + H2 + H3, b1 + b2 + b3

    def robust_cost(R, t, w_pt_mask, w_ln_mask, robust):
        chi_pt, chi_ln = chi2(R, t)

        def rho(chi, d2):
            if not robust:
                return chi
            return torch.where(chi > d2, 2.0 * torch.sqrt(d2 * chi.clamp(min=0.0)) - d2, chi)

        chi_pt = torch.where(torch.isfinite(chi_pt), chi_pt, torch.full_like(chi_pt, 1e9))
        c_pt = each(_sum_last, lead, rho(chi_pt, delta2_pt) * w_pt_mask)
        c_ln = each(_sum_last, lead, rho(chi_ln, torch.full_like(chi_ln, CHI2_LINE)) * w_ln_mask)
        return c_pt + c_ln

    def lm_round(R, t, in_pt, in_ln, robust):
        m_pt = (in_pt & obs.valid).float()
        m_ln = (in_ln & obs.line_valid).float()
        lam = torch.full(lead, 1e-5, dtype=torch.float32, device=dev)
        for _ in range(iters):
            H, b = build_normal_eqs(R, t, m_pt, m_ln, robust)
            cost0 = robust_cost(R, t, m_pt, m_ln, robust)
            Hd = (H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
                  + 1e-9 * eye6)
            xi = each(_solve6, lead, Hd, b)
            Rn, tn = se3.left_update(xi, R, t)
            cost1 = robust_cost(Rn, tn, m_pt, m_ln, robust)
            accept = (cost1 < cost0) & torch.isfinite(tn).all(-1)
            R = torch.where(accept[..., None, None], Rn, R)
            t = torch.where(accept[..., None], tn, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        # re-classify by chi2 at the new pose (Optimizer.cc:2436-2476)
        chi_pt, chi_ln = chi2(R, t)
        in_pt = (chi_pt <= delta2_pt) & obs.valid
        in_ln = (chi_ln <= CHI2_LINE) & obs.line_valid
        return R, t, in_pt, in_ln

    R, t = se3.orthonormalize(R0), t0
    in_pt, in_ln = obs.valid, obs.line_valid
    for r in range(rounds):
        R, t, in_pt, in_ln = lm_round(R, t, in_pt, in_ln, robust=(r < 2))
        R = se3.orthonormalize(R)
    return PoseResult(R, t, in_pt, in_ln, in_pt.sum(-1, dtype=torch.int32))
