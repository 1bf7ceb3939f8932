"""Closed-form rigid / similarity alignment and batched RANSAC.

The minimal-solver engine behind relocalization and loop closing, in place
of the reference's ``Sim3Solver`` (Horn's method inside a RANSAC loop,
Sim3Solver.cc) and, for RGB-D, its EPnP relocalization (PnPsolver.cc):
with depth at every keypoint, 3D-3D alignment is better conditioned than
3D-2D EPnP, and the RANSAC (hundreds of 3-point Kabsch solves and their
inlier counts) runs as one batched tensor program instead of the
reference's sequential ``iterate()`` loop. The counterpart of
``optim/horn.py`` in the JAX package.

The 3x3 SVDs of all hypotheses are one batched ``torch.linalg.svd`` call;
poses are compared between implementations, never U / V, whose signs are
free. Hypothesis draws come from a ``torch.Generator``, or are injected
(``samples``) to reproduce another implementation's draws.
"""

from __future__ import annotations

import torch

from ..geometry import se3


def _wsum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_n w[..., n] * x[..., n, :]"""
    return (x * w[..., None]).sum(-2)


def kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor | None = None,
           with_scale: bool = False):
    """Least-squares (s, R, t) with dst ≈ s * R @ src + t. src / dst:
    (..., N, 3), w: (..., N); leading dimensions are a batch of problems."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = w.sum(-1, keepdim=True) + 1e-9
    cs = _wsum(src, w) / wsum
    cd = _wsum(dst, w) / wsum
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    H = (s0 * w[..., None]).mT @ d0
    U, S, Vt = torch.linalg.svd(H)
    V = Vt.mT
    d = torch.sign(torch.linalg.det(V @ U.mT))
    D = torch.ones(S.shape, dtype=src.dtype, device=src.device)
    D = torch.cat([D[..., :2], d[..., None]], -1)
    R = (V * D[..., None, :]) @ U.mT
    if with_scale:
        # Umeyama: s = trace(D diag(S)) / sum_w ||src - c||^2
        var = (w[..., None] * s0 * s0).sum((-1, -2))
        scale = (S * D).sum(-1) / (var + 1e-12)
    else:
        scale = torch.ones(R.shape[:-2], dtype=src.dtype, device=src.device)
    t = cd - scale[..., None] * (R @ cs[..., None])[..., 0]
    return scale, R, t


def _residuals(src, dst, s, R, t):
    """||dst - (s R src + t)|| for one model (M,) or a batch of them (H, M)."""
    pred = s[..., None, None] * (src @ R.mT) + t[..., None, :]
    return torch.linalg.vector_norm(dst - pred, dim=-1)


def _draw_samples(valid: torch.Tensor, n_hyp: int, size: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_hyp, size) positions drawn uniformly with replacement from
    [0, max(n_valid, size)), computed on the device (no host sync)."""
    pool = valid.sum().clamp(min=size).float()
    u = torch.rand((n_hyp, size), generator=generator, device=valid.device)
    return (u * pool).long().clamp(max=valid.shape[0] - 1)


def ransac_align(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                 generator: torch.Generator | None = None, thresh: float = 0.07,
                 n_hyp: int = 256, with_scale: bool = False,
                 samples: torch.Tensor | None = None):
    """Batched 3-point RANSAC for dst ≈ s R src + t; src / dst (M, 3),
    valid (M,).

    Hypotheses sample among the valid rows: ``samples`` (n_hyp, 3) are
    positions in the stable valid-first order of the rows, drawn from
    ``generator`` unless given. The best hypothesis (the first of the most
    inliers) is refit four times on its inliers at a shrinking threshold.
    Returns (s, R, t, inliers (M,), n_inliers)."""
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices  # valid first
    if samples is None:
        samples = _draw_samples(valid, n_hyp, 3, generator)
    idx = order[samples.long()]                                       # (H, 3)
    ss, Rs, ts = kabsch(src[idx], dst[idx], with_scale=with_scale)
    inl_all = (_residuals(src, dst, ss, Rs, ts) < thresh) & valid    # (H, M)
    best = torch.argmax(inl_all.sum(-1, dtype=torch.int32))          # first maximum
    s_c, R_c, t_c, inl_c = ss[best], Rs[best], ts[best], inl_all[best]

    # iterative trimmed refit: refit on the inliers, re-gate at a SHRINKING
    # threshold (thresh, thresh/2, thresh/4, thresh/4, floored at 1 cm):
    # the wide RANSAC gate finds the consensus basin, the trimming converges
    # to the tight rigid core instead of averaging near-miss wrong matches in
    for th in (thresh, 0.5 * thresh, 0.25 * thresh, 0.25 * thresh):
        th = max(th, 0.01)
        s_f, R_f, t_f = kabsch(src, dst, w=inl_c.float(), with_scale=with_scale)
        inl_f = (_residuals(src, dst, s_f, R_f, t_f) < th) & valid
        # keep the refit only while it retains a usable support set
        n_c = inl_c.sum(dtype=torch.int32)
        ok = inl_f.sum(dtype=torch.int32) >= torch.clamp(n_c // 4, min=8)
        s_c = torch.where(ok, s_f, s_c)
        R_c = torch.where(ok, R_f, R_c)
        t_c = torch.where(ok, t_f, t_c)
        inl_c = torch.where(ok, inl_f, inl_c)
    return s_c, R_c, t_c, inl_c, inl_c.sum(dtype=torch.int32)


def refine_sim3(cam, s0, R12, t12, x1, uv1, x2, uv2, valid,
                chi2_th: float = 10.0, iters: int = 8, with_scale: bool = True):
    """Sim3 LM refinement on bidirectional reprojection errors
    (Optimizer::OptimizeSim3, Optimizer.cc:1400-1659: EdgeSim3ProjectXYZ
    projects x2 through S12 into image 1 and EdgeInverseSim3ProjectXYZ
    projects x1 through S12^-1 into image 2; chi2 gate 10; scale frozen when
    bFixScale), with sqrt-Huber IRLS weights from the current residuals and
    the 7-parameter Jacobian from ``torch.func.jacfwd``.

    x1 / x2: (N, 3) camera-frame points; uv1 / uv2: (N, 2) their pixel
    observations in the OTHER frame's image. Returns (s, R, t, inliers,
    n_inliers)."""
    dev, dt = x1.device, x1.dtype
    vm = valid.to(dt)[:, None]

    def project(p):
        z = p[:, 2]
        z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
        return torch.stack([cam.fx * p[:, 0] / z + cam.cx, cam.fy * p[:, 1] / z + cam.cy], -1)

    def pose(params):
        R = se3.so3_exp(params[:3]) @ R12
        t = t12 + params[3:6]
        s = s0 * torch.exp(params[6] if with_scale else torch.zeros_like(params[6]))
        return s, R, t

    def residuals(params, w_rob):
        s, R, t = pose(params)
        r1 = (project(s * (x2 @ R.T) + t) - uv1) * vm   # x2 -> frame 1
        r2 = (project((x1 - t) @ R / s) - uv2) * vm     # x1 -> frame 2
        return (torch.cat([r1, r2], 0) * w_rob[:, None]).reshape(-1)

    def huber_w(params):
        # g2o's RobustKernelHuber on the Sim3 edges, as a smooth IRLS weight
        # that keeps the many wrong ratio matches from dragging the fit
        r = residuals(params, torch.ones(2 * x1.shape[0], dtype=dt, device=dev))
        e = torch.sqrt((r.reshape(-1, 2) ** 2).sum(-1) + 1e-12)
        return torch.sqrt(torch.clamp(chi2_th ** 0.5 / e, max=1.0))

    params = torch.zeros(7, dtype=dt, device=dev)
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    eye = torch.eye(7, dtype=dt, device=dev)
    for _ in range(iters):
        w_rob = huber_w(params)
        r = residuals(params, w_rob)
        J = torch.func.jacfwd(residuals)(params, w_rob)
        dp = -torch.linalg.solve_ex(J.T @ J + lam * eye, J.T @ r)[0]
        new = params + dp
        better = (residuals(new, w_rob) ** 2).sum() < (r ** 2).sum()
        params = torch.where(better, new, params)
        lam = torch.where(better, lam * 0.5, lam * 5.0).clamp(1e-8, 1e2)
    s, R, t = pose(params)
    e1 = ((project(s * (x2 @ R.T) + t) - uv1) ** 2).sum(-1)
    e2 = ((project((x1 - t) @ R / s) - uv2) ** 2).sum(-1)
    inl = valid & (e1 < chi2_th) & (e2 < chi2_th)
    return s, R, t, inl, inl.sum(dtype=torch.int32)
