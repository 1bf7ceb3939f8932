"""EPnP and batched EPnP RANSAC: the reference's ``PnPsolver``.

PnPsolver.cc (Lepetit et al.'s EPnP inside a sequential RANSAC
``iterate()`` loop, used by Tracking::Relocalization, Tracking.cc:
2105-2131) as batched tensor programs, the counterpart of ``optim/epnp.py``
in the JAX package:

- control points = centroid + principal axes (choose_control_points),
- barycentric coordinates of every 3D point,
- the 2n x 12 projection constraint matrix M and the eigenvector of the
  smallest eigenvalue of M^T M (12x12 ``eigh``, batched),
- the N=1 beta (inter-control-point distances matched to the world's) and
  a Procrustes fit (Kabsch) between world and camera control points, as
  estimate_R_and_t,
- RANSAC = one batched solve over hundreds of 6-point minimal sets with a
  chi2 reprojection inlier count (CheckInliers), then a refit on the best
  hypothesis' inliers (Refine).

The reference runs 300 sequential iterations with early exit; here every
hypothesis is solved at once and the best is the first of the most
inliers. The signs of the control-point axes (eigenvectors) are free, and
they change a noisy least-squares answer slightly: compare poses between
implementations to a tolerance.
"""

from __future__ import annotations

import torch

from .horn import kabsch

MIN_SET = 6  # points per hypothesis (>= 6 keeps M^T M well determined)


def _control_points(pw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Centroid + PCA-axes control points (..., 4, 3) of weighted points."""
    wsum = w.sum(-1)[..., None] + 1e-9
    c0 = (pw * w[..., None]).sum(-2) / wsum
    centered = (pw - c0[..., None, :]) * w[..., None]
    cov = centered.mT @ centered / wsum[..., None]
    eval_, evec = torch.linalg.eigh(cov)  # ascending
    axes = evec.mT * torch.sqrt(eval_.clamp(min=1e-12))[..., None]
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes], -2)


def _barycentric(pw: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """alphas (..., N, 4) with pw = alphas @ cw."""
    base = (cw[..., 1:, :] - cw[..., :1, :]).mT  # (..., 3, 3)
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device)
    base_inv = torch.linalg.inv_ex(base + 1e-12 * eye)[0]
    a123 = (pw - cw[..., :1, :]) @ base_inv.mT
    return torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)


def _solve(cam, pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor):
    """EPnP on weighted point sets: pw (..., N, 3) world, uv (..., N, 2)
    pixels, w (..., N) weights (0 excludes). Returns (R, t) world->camera."""
    cw = _control_points(pw, w)
    a = _barycentric(pw, cw)  # (..., N, 4)
    du = (cam.cx - uv[..., 0])[..., None]
    dv = (cam.cy - uv[..., 1])[..., None]
    zeros = torch.zeros_like(a)
    shape = a.shape[:-1] + (12,)
    # row_u[j, 3k:3k+3] = [a_k fu, 0, a_k (uc - u)], row_v likewise
    row_u = torch.stack([a * cam.fx, zeros, a * du], -1).reshape(shape)
    row_v = torch.stack([zeros, a * cam.fy, a * dv], -1).reshape(shape)
    sw = torch.sqrt(w.clamp(min=0.0))[..., None]
    M = torch.cat([row_u * sw, row_v * sw], -2)  # (..., 2N, 12)
    _, vecs = torch.linalg.eigh(M.mT @ M)       # ascending eigenvalues
    v = vecs[..., 0].reshape(vecs.shape[:-2] + (4, 3))  # camera control points

    # N=1 beta: scale v so that inter-control distances match the world's,
    # sign so that the points end up in front of the camera
    dw = torch.linalg.vector_norm(cw[..., :, None, :] - cw[..., None, :, :], dim=-1)
    dvv = torch.linalg.vector_norm(v[..., :, None, :] - v[..., None, :, :], dim=-1)
    beta = (dvv * dw).sum((-1, -2)) / ((dvv**2).sum((-1, -2)) + 1e-12)
    cc = beta[..., None, None] * v
    depth = ((a @ cc)[..., 2] * w).sum(-1)
    cc = cc * torch.where(depth < 0, -1.0, 1.0)[..., None, None]
    _, R, t = kabsch(cw, cc)  # world -> camera control points (Procrustes)
    return R, t


def _chi2(cam, R, t, pw, uv):
    """Squared reprojection error (..., M) of pw under one pose or a batch;
    inf behind the camera."""
    pc = pw @ R.mT + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    return torch.where(z > 0.05, err, torch.full_like(err, float("inf")))


def draw_sets(valid: torch.Tensor, n_hyp: int, generator: torch.Generator | None = None):
    """(n_hyp, MIN_SET) distinct row indices, each set uniform among the
    valid rows: the MIN_SET largest of uniform keys, invalid rows last."""
    keys = torch.rand((n_hyp, valid.shape[0]), generator=generator, device=valid.device)
    keys = torch.where(valid, keys, torch.full_like(keys, -1.0))
    return torch.topk(keys, MIN_SET, dim=1).indices


def ransac_epnp(cam, pw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator | None = None, thresh: float = 5.991,
                n_hyp: int = 256, samples: torch.Tensor | None = None):
    """Batched EPnP RANSAC over pw (M, 3), uv (M, 2), valid (M,); chi2
    threshold in px^2 (Tracking.cc:2113). ``samples`` (n_hyp, MIN_SET) row
    indices are drawn from ``generator`` unless given. Returns (R, t,
    inliers (M,), n_inliers)."""
    if samples is None:
        samples = draw_sets(valid, n_hyp, generator)
    samples = samples.long()
    ones = torch.ones(samples.shape, dtype=pw.dtype, device=pw.device)
    Rs, ts = _solve(cam, pw[samples], uv[samples], ones)
    inl = (_chi2(cam, Rs, ts, pw, uv) <= thresh) & valid  # (H, M)
    scores = inl.sum(-1, dtype=torch.int32)
    best = torch.argmax(scores)  # first maximum
    # refit on the best hypothesis' inliers (PnPsolver::Refine)
    R1, t1 = _solve(cam, pw, uv, inl[best].to(pw.dtype))
    inl1 = (_chi2(cam, R1, t1, pw, uv) <= thresh) & valid
    better = inl1.sum(dtype=torch.int32) >= scores[best]
    inliers = torch.where(better, inl1, inl[best])
    return (torch.where(better, R1, Rs[best]), torch.where(better, t1, ts[best]),
            inliers, inliers.sum(dtype=torch.int32))
