"""Bundle adjustment: Schur-complement Levenberg–Marquardt over keyframe
cohorts, the port of the JAX package's ``optim/local_ba.py`` (the reference's g2o
BlockSolver + LM, Optimizer.cc:644-1063 LocalBundleAdjustment).

Per iteration, on fixed padded shapes:

- residuals per observation: a point observation has 3 rows (u, v and the
  virtual right u, zero for a mono observation); a line landmark is its
  two 3D endpoints (6 dof) and its residual the signed distances of both
  observed endpoints to the image line through the projected endpoints
  (the reference's dead-code design, Optimizer.cc:1670-2108);
- Jacobians analytic, for the left perturbation exp(xi) ∘ (R, t) at
  xi = 0 and an additive landmark step (the derivatives the JAX package
  takes with forward-mode autodiff; ``tests/test_torch_local_ba.py`` holds
  them against ``torch.func.jacfwd`` of this module's residuals);
- block accumulation with ``index_put_(accumulate=True)``: U (6x6 per
  camera), V (3x3 per point, 6x6 per line), A (camera x landmark). On CUDA
  it sorts the indices and sums each block's terms in that order, so a BA
  result on the card is reproducible (``index_add_`` sums with atomics, in
  an order that changes from run to run; a tracker beside its mapper could
  then not be compared with the same tracker run again); on the CPU both
  sum in index order;
- the Schur complement of every landmark block as one dense (6C, 6C)
  system (C <= 64 here), solved with ``torch.linalg.solve_ex``, then
  landmark back-substitution;
- Huber kernels (delta^2 = 5.991 / 7.815 / 2 x 7.815 as the reference) and
  accept/reject plus the damping update as ``torch.where`` on the device:
  the host reads nothing until the caller fetches the result;
- chi2 reclassification between the two phases (Optimizer.cc:806-860).

``bundle_adjust`` and ``bundle_adjust_stepped`` solve in float64
(``SOLVE_DTYPE``) and return float32, where the JAX package solves in
float32. A line landmark's endpoints can slide along the line without
changing its residual, so its 6x6 block is near singular and its Schur term
amplifies float32 rounding: on a 3-keyframe local BA of the synthetic room
a float32 solve (JAX's or this one) lands 5-13 mm and 1.5-3.8 mrad from
the float64 optimum, which both packages reach to 1e-13 in float64
(``tests/test_torch_local_ba.py``). Every function takes either type.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
CHI2_LINE = 2.0 * 7.815
SOLVE_DTYPE = torch.float64


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. Index tensors point into the padded camera
    and landmark tensors; padding entries have valid=False."""

    cam_R: torch.Tensor        # (C, 3, 3)
    cam_t: torch.Tensor        # (C, 3)
    cam_fixed: torch.Tensor    # (C,) bool, pose held constant
    cam_valid: torch.Tensor    # (C,) bool
    pt_xyz: torch.Tensor       # (P, 3)
    pt_valid: torch.Tensor     # (P,) bool
    obs_cam: torch.Tensor      # (O,) int64
    obs_pt: torch.Tensor       # (O,) int64
    obs_uv: torch.Tensor       # (O, 2)
    obs_ur: torch.Tensor       # (O,) virtual right u, or -1
    obs_w: torch.Tensor        # (O,) inverse sigma^2
    obs_valid: torch.Tensor    # (O,) bool
    ln_ep: torch.Tensor        # (L, 2, 3)
    ln_valid: torch.Tensor     # (L,) bool
    lobs_cam: torch.Tensor     # (OL,) int64
    lobs_ln: torch.Tensor      # (OL,) int64
    lobs_uv: torch.Tensor      # (OL, 2, 2) observed endpoints
    lobs_w: torch.Tensor       # (OL,)
    lobs_valid: torch.Tensor   # (OL,) bool


class BAResult(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    pt_xyz: torch.Tensor
    ln_ep: torch.Tensor
    obs_inlier: torch.Tensor   # (O,) bool, chi2 classification after BA
    lobs_inlier: torch.Tensor  # (OL,)
    cost: torch.Tensor


def make_problem(C, P, O, L=1, OL=1, device="cuda") -> BAProblem:
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    z = torch.zeros
    return BAProblem(
        cam_R=torch.eye(3, **f32).expand(C, 3, 3).clone(), cam_t=z(C, 3, **f32),
        cam_fixed=z(C, **b), cam_valid=z(C, **b),
        pt_xyz=z(P, 3, **f32), pt_valid=z(P, **b),
        obs_cam=z(O, **i64), obs_pt=z(O, **i64), obs_uv=z(O, 2, **f32),
        obs_ur=torch.full((O,), -1.0, **f32), obs_w=torch.ones(O, **f32),
        obs_valid=z(O, **b),
        ln_ep=z(L, 2, 3, **f32), ln_valid=z(L, **b),
        lobs_cam=z(OL, **i64), lobs_ln=z(OL, **i64), lobs_uv=z(OL, 2, 2, **f32),
        lobs_w=torch.ones(OL, **f32), lobs_valid=z(OL, **b),
    )


def _proj(cam, pc):
    """(u, v) of camera-frame points and, per point, 1/z and 1/z^2 with the
    depth clamp (|z| <= 1e-6 -> 1e-6, which has no depth derivative)."""
    z = pc[..., 2]
    ok_z = z.abs() > 1e-6
    zs = torch.where(ok_z, z, torch.full_like(z, 1e-6))
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    iz = 1.0 / zs
    iz2 = torch.where(ok_z, iz * iz, torch.zeros_like(iz))
    return u, v, zs, iz, iz2


def _pt_residual(cam, R, t, X, uv, ur, xi=None, dx=None):
    """Point residuals (..., 3): [du, dv, dur]; the dur row is 0 for mono.
    ``xi`` / ``dx`` perturb the camera (left) and the point."""
    if xi is not None:
        R, t = se3.left_update(xi, R, t)
    if dx is not None:
        X = X + dx
    pc = se3._mv(R, X) + t
    u, v, zs, _, _ = _proj(cam, pc)
    urp = u - cam.bf / zs
    r_ur = torch.where(ur >= 0, urp - ur, torch.zeros_like(urp))
    return torch.stack([u - uv[..., 0], v - uv[..., 1], r_ur], -1)


def _line_terms(cam, R, t, ep):
    pa = se3._mv(R, ep[..., 0, :]) + t
    pb = se3._mv(R, ep[..., 1, :]) + t
    ua, va, _, iza, iz2a = _proj(cam, pa)
    ub, vb, _, izb, iz2b = _proj(cam, pb)
    l = torch.stack([va - vb, ub - ua, ua * vb - va * ub], -1)
    n = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2 + 1e-12)
    return pa, pb, (ua, va, iza, iz2a), (ub, vb, izb, iz2b), l, n


def _ln_residual(cam, R, t, ep, uv_obs, xi=None, dep=None):
    """Line residuals (..., 2): signed distances of the two observed
    endpoints to the image line through the projected landmark endpoints."""
    if xi is not None:
        R, t = se3.left_update(xi, R, t)
    if dep is not None:
        ep = ep + dep.reshape(ep.shape)
    _, _, _, _, l, n = _line_terms(cam, R, t, ep)
    d = [(l[..., 0] * uv_obs[..., k, 0] + l[..., 1] * uv_obs[..., k, 1] + l[..., 2]) / n
         for k in (0, 1)]
    return torch.stack(d, -1)


def _proj_grads(cam, pc, iz, iz2):
    """d(u, v)/d pc (..., 2, 3)."""
    x, y = pc[..., 0], pc[..., 1]
    zero = torch.zeros_like(iz)
    du = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    dv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)
    return torch.stack([du, dv], -2)


def _pt_jacobians(cam, R, t, X, ur):
    """(Jc (O, 3, 6), Jp (O, 3, 3)) of :func:`_pt_residual` at xi = 0,
    dx = 0. A camera-frame point moves by omega x pc + upsilon."""
    pc = se3._mv(R, X) + t
    _, _, _, iz, iz2 = _proj(cam, pc)
    G = _proj_grads(cam, pc, iz, iz2)                       # (O, 2, 3)
    g_ur = G[:, 0] + torch.stack([torch.zeros_like(iz), torch.zeros_like(iz),
                                  cam.bf * iz2], -1)
    g_ur = torch.where((ur >= 0)[:, None], g_ur, torch.zeros_like(g_ur))
    G = torch.cat([G, g_ur[:, None]], 1)                    # (O, 3, 3)
    Jc = torch.cat([torch.linalg.cross(pc[:, None].expand_as(G), G, dim=-1), G], -1)
    return Jc, G @ R


def _ln_jacobians(cam, R, t, ep, uv_obs):
    """(Jc (OL, 2, 6), Jl (OL, 2, 6)) of :func:`_ln_residual` at xi = 0,
    dep = 0, by the chain rule through the homogeneous image line."""
    pa, pb, (ua, va, iza, iz2a), (ub, vb, izb, iz2b), l, n = _line_terms(cam, R, t, ep)
    n3 = n * n * n
    zero = torch.zeros_like(ua)
    one = torch.ones_like(ua)
    # dl/da, dl/db (OL, 3, 2) for l = [va - vb, ub - ua, ua vb - va ub]
    dl_da = torch.stack([torch.stack([zero, one], -1), torch.stack([-one, zero], -1),
                         torch.stack([vb, -ub], -1)], -2)
    dl_db = torch.stack([torch.stack([zero, -one], -1), torch.stack([one, zero], -1),
                         torch.stack([-va, ua], -1)], -2)
    Ga = _proj_grads(cam, pa, iza, iz2a)                    # (OL, 2, 3)
    Gb = _proj_grads(cam, pb, izb, iz2b)
    rows_c, rows_l = [], []
    for k in (0, 1):
        x, y = uv_obs[:, k, 0], uv_obs[:, k, 1]
        num = l[:, 0] * x + l[:, 1] * y + l[:, 2]
        dd = torch.stack([x / n - num * l[:, 0] / n3, y / n - num * l[:, 1] / n3,
                          1.0 / n], -1)                     # (OL, 3)
        ga = ((dd[:, None, :] @ dl_da) @ Ga)[:, 0]          # (OL, 3)
        gb = ((dd[:, None, :] @ dl_db) @ Gb)[:, 0]
        rows_c.append(torch.cat([torch.linalg.cross(pa, ga, dim=-1)
                                 + torch.linalg.cross(pb, gb, dim=-1), ga + gb], -1))
        rows_l.append(torch.cat([(ga[:, None] @ R)[:, 0], (gb[:, None] @ R)[:, 0]], -1))
    return torch.stack(rows_c, 1), torch.stack(rows_l, 1)


def _huber_w(chi2, delta2):
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / chi2.clamp(min=1e-12)))


def _delta2_pt(prob):
    return torch.where(prob.obs_ur >= 0, torch.full_like(prob.obs_ur, CHI2_STEREO),
                       torch.full_like(prob.obs_ur, CHI2_MONO))


def _chi2_all(cam, prob, cam_R, cam_t, pt_xyz, ln_ep):
    Ro = cam_R[prob.obs_cam]
    to = cam_t[prob.obs_cam]
    Xo = pt_xyz[prob.obs_pt]
    r = _pt_residual(cam, Ro, to, Xo, prob.obs_uv, prob.obs_ur)
    chi_pt = (r**2).sum(-1) * prob.obs_w
    pc_z = (Ro[:, 2, :] * Xo).sum(-1) + to[:, 2]  # behind-camera guard
    chi_pt = torch.where(pc_z <= 0.05, torch.full_like(chi_pt, float("inf")), chi_pt)
    rl = _ln_residual(cam, cam_R[prob.lobs_cam], cam_t[prob.lobs_cam],
                      ln_ep[prob.lobs_ln], prob.lobs_uv)
    chi_ln = (rl**2).sum(-1) * prob.lobs_w
    return chi_pt, chi_ln


def _robust_cost(cam, prob, cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, use_robust):
    chi_pt, chi_ln = _chi2_all(cam, prob, cam_R, cam_t, pt_xyz, ln_ep)

    def rho(chi, d2):
        chi = torch.where(torch.isfinite(chi), chi, torch.full_like(chi, 1e9))
        if not use_robust:
            return chi
        return torch.where(chi > d2, 2.0 * torch.sqrt(d2 * chi.clamp(min=0.0)) - d2, chi)

    c1 = (rho(chi_pt, _delta2_pt(prob)) * (in_pt & prob.obs_valid)).sum()
    c2 = (rho(chi_ln, torch.full_like(chi_ln, CHI2_LINE)) * (in_ln & prob.lobs_valid)).sum()
    return c1 + c2


def _add_at(acc, idx, blocks):
    """acc[idx[i]] += blocks[i], in a fixed order on every device."""
    return acc.index_put_((idx,), blocks, accumulate=True)


def _block_sum(n, idx, blocks):
    return _add_at(torch.zeros((n,) + blocks.shape[1:], dtype=blocks.dtype,
                               device=blocks.device), idx, blocks)


def _damp(M, lam, eps):
    """M + lam * diag(M) + eps * I over a batch of square blocks."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + lam * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1)) + eps * eye


def _schur(A, Vinv):
    """(sum_p A_p V_p^-1 A_p^T as a (6C, 6C) matrix, A V^-1 (P, C, 6, k))
    for blocks A (P, C, 6, k)."""
    P, C, _, k = A.shape
    AV = torch.einsum("pcij,pjk->pcik", A, Vinv)
    S = AV.permute(1, 2, 0, 3).reshape(6 * C, P * k) @ \
        A.permute(1, 2, 0, 3).reshape(6 * C, P * k).T
    return S, AV


def _lm_iteration(cam, prob, state, use_robust):
    """One damped LM step: residuals and Jacobians, Schur solve,
    accept/reject (the body of g2o's OptimizationAlgorithmLevenberg)."""
    C = prob.cam_R.shape[0]
    P = prob.pt_xyz.shape[0]
    L = prob.ln_ep.shape[0]
    cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, lam = state
    dev = cam_R.device

    # ---- points -----------------------------------------------------
    Ro, to, Xo = cam_R[prob.obs_cam], cam_t[prob.obs_cam], pt_xyz[prob.obs_pt]
    r = _pt_residual(cam, Ro, to, Xo, prob.obs_uv, prob.obs_ur)
    Jc, Jp = _pt_jacobians(cam, Ro, to, Xo, prob.obs_ur)
    chi = (r**2).sum(-1) * prob.obs_w
    w_rob = _huber_w(chi, _delta2_pt(prob)) if use_robust else torch.ones_like(chi)
    w = (prob.obs_w * w_rob * (in_pt & prob.obs_valid))[:, None, None]
    JcW, JpW = Jc * w, Jp * w
    U = _block_sum(C, prob.obs_cam, JcW.mT @ Jc)
    V = _block_sum(P, prob.obs_pt, JpW.mT @ Jp)
    bc = _block_sum(C, prob.obs_cam, -(JcW.mT @ r[..., None])[..., 0])
    bp = _block_sum(P, prob.obs_pt, -(JpW.mT @ r[..., None])[..., 0])
    A = _block_sum(P * C, prob.obs_pt * C + prob.obs_cam, JcW.mT @ Jp).view(P, C, 6, 3)

    # ---- lines ------------------------------------------------------
    Rl, tl, El = cam_R[prob.lobs_cam], cam_t[prob.lobs_cam], ln_ep[prob.lobs_ln]
    rl = _ln_residual(cam, Rl, tl, El, prob.lobs_uv)
    Jcl, Jl = _ln_jacobians(cam, Rl, tl, El, prob.lobs_uv)
    chil = (rl**2).sum(-1) * prob.lobs_w
    wl_rob = (_huber_w(chil, torch.full_like(chil, CHI2_LINE)) if use_robust
              else torch.ones_like(chil))
    wl = (prob.lobs_w * wl_rob * (in_ln & prob.lobs_valid))[:, None, None]
    JclW, JlW = Jcl * wl, Jl * wl
    U = _add_at(U, prob.lobs_cam, JclW.mT @ Jcl)
    Vl = _block_sum(L, prob.lobs_ln, JlW.mT @ Jl)
    bc = _add_at(bc, prob.lobs_cam, -(JclW.mT @ rl[..., None])[..., 0])
    bl = _block_sum(L, prob.lobs_ln, -(JlW.mT @ rl[..., None])[..., 0])
    Al = _block_sum(L * C, prob.lobs_ln * C + prob.lobs_cam, JclW.mT @ Jl).view(L, C, 6, 6)

    free = (~prob.cam_fixed & prob.cam_valid).to(cam_R.dtype)
    m6 = free.repeat_interleave(6)
    eyeC = torch.eye(C, dtype=cam_R.dtype, device=dev)

    def solve_with_damping(lam):
        Vinv = torch.linalg.inv_ex(_damp(V, lam, 1e-6))[0]
        Vlinv = torch.linalg.inv_ex(_damp(Vl, lam, 1e-6))[0]
        S_pt, AV = _schur(A, Vinv)
        S_ln, AVl = _schur(Al, Vlinv)
        Ud = _damp(U, lam, 0.0)
        S = torch.einsum("cij,cd->cidj", Ud, eyeC).reshape(6 * C, 6 * C) - S_pt - S_ln
        bt = bc - torch.einsum("pcik,pk->ci", AV, bp) - torch.einsum("pcik,pk->ci", AVl, bl)
        # fixed / invalid cameras: identity rows
        S = S * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
        bt = bt * free[:, None]
        Sd = S + 1e-8 * torch.eye(6 * C, dtype=cam_R.dtype, device=dev)
        xi = torch.linalg.solve_ex(Sd, bt.reshape(-1))[0].reshape(C, 6)
        # back-substitute the landmarks
        dX = (Vinv @ (bp - torch.einsum("pcik,ci->pk", A, xi))[..., None])[..., 0]
        dE = (Vlinv @ (bl - torch.einsum("pcik,ci->pk", Al, xi))[..., None])[..., 0]
        Rn, tn = se3.left_update(xi, cam_R, cam_t)
        Rn = se3.orthonormalize(Rn)
        keep = prob.cam_fixed | ~prob.cam_valid
        tn = torch.where(keep[:, None], cam_t, tn)
        Rn = torch.where(keep[:, None, None], cam_R, Rn)
        has_obs_p = torch.diagonal(V, dim1=-2, dim2=-1).sum(-1) > 1e-9
        Xn = torch.where((prob.pt_valid & has_obs_p)[:, None], pt_xyz + dX, pt_xyz)
        has_obs_l = torch.diagonal(Vl, dim1=-2, dim2=-1).sum(-1) > 1e-9
        En = torch.where((prob.ln_valid & has_obs_l)[:, None, None],
                         ln_ep + dE.reshape(L, 2, 3), ln_ep)
        return Rn, tn, Xn, En

    cost0 = _robust_cost(cam, prob, cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, use_robust)
    Rn, tn, Xn, En = solve_with_damping(lam)
    cost1 = _robust_cost(cam, prob, Rn, tn, Xn, En, in_pt, in_ln, use_robust)
    accept = (cost1 < cost0) & torch.isfinite(cost1)
    cam_R = torch.where(accept, Rn, cam_R)
    cam_t = torch.where(accept, tn, cam_t)
    pt_xyz = torch.where(accept, Xn, pt_xyz)
    ln_ep = torch.where(accept, En, ln_ep)
    lam = torch.where(accept, lam * 0.3, lam * 5.0).clamp(1e-9, 1e6)
    return (cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, lam)


def ba_state_init(prob: BAProblem):
    """Initial LM state for the stepped API."""
    lam = torch.tensor(1e-4, dtype=prob.cam_R.dtype, device=prob.cam_R.device)
    return (prob.cam_R, prob.cam_t, prob.pt_xyz, prob.ln_ep,
            prob.obs_valid, prob.lobs_valid, lam)


def ba_iterate_chunk(cam, prob: BAProblem, state, robust: bool = True, n: int = 5):
    """``n`` LM iterations, enqueued with no host sync in between."""
    for _ in range(n):
        state = _lm_iteration(cam, prob, state, robust)
    return state


def ba_reclassify(cam, prob: BAProblem, state):
    """chi2 inlier reclassification between the two phases
    (Optimizer.cc:806-860)."""
    cam_R, cam_t, pt_xyz, ln_ep, _, _, lam = state
    chi_pt, chi_ln = _chi2_all(cam, prob, cam_R, cam_t, pt_xyz, ln_ep)
    in_pt = (chi_pt <= _delta2_pt(prob)) & prob.obs_valid
    in_ln = (chi_ln <= CHI2_LINE) & prob.lobs_valid
    return (cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, lam)


def ba_finalize(cam, prob: BAProblem, state) -> BAResult:
    """Final chi2 classification and cost."""
    cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, _ = ba_reclassify(cam, prob, state)
    cost = _robust_cost(cam, prob, cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, False)
    return BAResult(cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, cost)


def _astype(x, dtype):
    """A problem, state tuple or result with its floating tensors in ``dtype``."""
    return type(x)(*(v.to(dtype) if v.is_floating_point() else v for v in x))


def bundle_adjust_stepped(cam, prob: BAProblem, iters1: int = 5, iters2: int = 10,
                          robust: bool = True, should_abort=None) -> BAResult:
    """Two-phase LM BA in chunks of 5 iterations, solved in ``SOLVE_DTYPE``.
    ``should_abort()`` is polled between chunks; on abort the current state
    is finalized early (mbAbortBA semantics).
    ``bundle_adjust_stepped.runs`` counts calls."""
    bundle_adjust_stepped.runs += 1
    dtype = prob.cam_R.dtype
    prob = _astype(prob, SOLVE_DTYPE)
    state = ba_state_init(prob)
    aborted = False
    chunk = 5
    for i in range(0, iters1, chunk):
        state = ba_iterate_chunk(cam, prob, state, robust, n=min(chunk, iters1 - i))
        if should_abort is not None and should_abort():
            aborted = True
            break
    if not aborted:
        state = ba_reclassify(cam, prob, state)
        for i in range(0, iters2, chunk):
            state = ba_iterate_chunk(cam, prob, state, robust, n=min(chunk, iters2 - i))
            if should_abort is not None and should_abort():
                break
    return _astype(ba_finalize(cam, prob, state), dtype)


bundle_adjust_stepped.runs = 0


def bundle_adjust(cam, prob: BAProblem, iters1: int = 5, iters2: int = 10,
                  robust: bool = True) -> BAResult:
    """Two-phase LM BA with chi2 reclassification between the phases:
    :func:`bundle_adjust_stepped` with no abort."""
    return bundle_adjust_stepped(cam, prob, iters1, iters2, robust)
