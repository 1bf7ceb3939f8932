"""Matrix-free Schur-complement bundle adjustment (preconditioned CG).

The port of the JAX package's ``optim/ba_cg.py``. The dense solver
(``optim/local_ba.py``) materializes the camera-landmark blocks as a
(P, C, 6, 3) tensor and the reduced camera system as (6C, 6C), which suits
local windows (C <= ``cfg.mapping.ba_dense_camera_cap``) but not a global BA
over the whole map. This module solves the same damped normal equations

    S xi = bt,   S = U_d - sum_p A_p V_p^-1 A_p^T

without forming A or S: a product S v is two passes over the observation
list per landmark family (gather camera blocks, scatter landmark blocks with
``index_add_``), the matrix-free Schur / PCG of "Bundle Adjustment in the
Large", so memory is O(O + C + P). The preconditioner is the exact block
diagonal of S (exact because a landmark observes a camera at most once),
inverted as a batch of 6x6 blocks with ``torch.linalg.inv_ex``; the CG runs
a fixed ``cg_iters`` with its guards as ``torch.where``, so nothing is read
back to the host inside an LM step, and LM's accept / reject absorbs what
the fixed count leaves unsolved.

Residuals, analytic Jacobians, robust weights, the initial state, the chi2
reclassification and the final classification are ``local_ba``'s, and the
solve is in ``local_ba.SOLVE_DTYPE`` (float64) as the dense solver's, so
the two solvers are interchangeable (the reference's GlobalBundleAdjustemnt,
Optimizer.cc:60-374, solves the same problem with g2o's sparse Cholesky).
"""

from __future__ import annotations

import torch

from ..geometry import se3
from . import local_ba
from .local_ba import (CHI2_LINE, BAProblem, BAResult, _block_sum, _damp, _delta2_pt,
                       _huber_w, _ln_jacobians, _ln_residual, _pt_jacobians, _pt_residual,
                       _robust_cost)


def _mv(M, v):
    """Batched matrix-vector products (N, a, b) x (N, b) -> (N, a)."""
    return (M @ v[..., None])[..., 0]


def _lm_iteration_cg(cam, prob: BAProblem, state, use_robust: bool, cg_iters: int):
    """One damped LM step with a matrix-free PCG solve of the reduced
    camera system; the state layout of ``local_ba._lm_iteration``."""
    C = prob.cam_R.shape[0]
    P = prob.pt_xyz.shape[0]
    L = prob.ln_ep.shape[0]
    cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, lam = state
    dt = cam_R.dtype

    # ---- per-observation residuals and Jacobians (as the dense solver) --
    Ro, to, Xo = cam_R[prob.obs_cam], cam_t[prob.obs_cam], pt_xyz[prob.obs_pt]
    r = _pt_residual(cam, Ro, to, Xo, prob.obs_uv, prob.obs_ur)
    Jc, Jp = _pt_jacobians(cam, Ro, to, Xo, prob.obs_ur)
    chi = (r**2).sum(-1) * prob.obs_w
    w_rob = _huber_w(chi, _delta2_pt(prob)) if use_robust else torch.ones_like(chi)
    w = prob.obs_w * w_rob * (in_pt & prob.obs_valid)

    Rl, tl, El = cam_R[prob.lobs_cam], cam_t[prob.lobs_cam], ln_ep[prob.lobs_ln]
    rl = _ln_residual(cam, Rl, tl, El, prob.lobs_uv)
    Jcl, Jl = _ln_jacobians(cam, Rl, tl, El, prob.lobs_uv)
    chil = (rl**2).sum(-1) * prob.lobs_w
    wl_rob = (_huber_w(chil, torch.full_like(chil, CHI2_LINE)) if use_robust
              else torch.ones_like(chil))
    wl = prob.lobs_w * wl_rob * (in_ln & prob.lobs_valid)

    # ---- diagonal blocks and gradient, no off-diagonal tensor ----------
    JcW, JclW = Jc * w[:, None, None], Jcl * wl[:, None, None]
    JpW, JlW = Jp * w[:, None, None], Jl * wl[:, None, None]
    U = _block_sum(C, prob.obs_cam, JcW.mT @ Jc).index_add_(0, prob.lobs_cam, JclW.mT @ Jcl)
    V = _block_sum(P, prob.obs_pt, JpW.mT @ Jp)
    Vl = _block_sum(L, prob.lobs_ln, JlW.mT @ Jl)
    bc = _block_sum(C, prob.obs_cam, -_mv(JcW.mT, r)).index_add_(
        0, prob.lobs_cam, -_mv(JclW.mT, rl))
    bp = _block_sum(P, prob.obs_pt, -_mv(JpW.mT, r))
    bl = _block_sum(L, prob.lobs_ln, -_mv(JlW.mT, rl))

    mfree = (~prob.cam_fixed & prob.cam_valid).to(dt)[:, None]
    eye6 = torch.eye(6, dtype=dt, device=cam_R.device)

    Vinv = torch.linalg.inv_ex(_damp(V, lam, 1e-6))[0]
    Vlinv = torch.linalg.inv_ex(_damp(Vl, lam, 1e-6))[0]
    Ud = _damp(U, lam, 0.0)

    # A^T v per landmark, and A z per camera, applied implicitly through the
    # observation list (JcW carries the single factor of W)
    def at_v(Jcw, Jlm, cam_idx, lm_idx, n, v):
        return _block_sum(n, lm_idx, _mv(Jlm.mT, _mv(Jcw, v[cam_idx])))

    def a_z(Jcw, Jlm, cam_idx, lm_idx, z):
        return _block_sum(C, cam_idx, _mv(Jcw.mT, _mv(Jlm, z[lm_idx])))

    def S_mul(v):
        v = v * mfree
        zp = _mv(Vinv, at_v(JcW, Jp, prob.obs_cam, prob.obs_pt, P, v))
        zl = _mv(Vlinv, at_v(JclW, Jl, prob.lobs_cam, prob.lobs_ln, L, v))
        return (_mv(Ud, v) - a_z(JcW, Jp, prob.obs_cam, prob.obs_pt, zp)
                - a_z(JclW, Jl, prob.lobs_cam, prob.lobs_ln, zl)) * mfree

    # rhs bt = bc - A Vinv bp - Al Vlinv bl
    bt = (bc - a_z(JcW, Jp, prob.obs_cam, prob.obs_pt, _mv(Vinv, bp))
          - a_z(JclW, Jl, prob.lobs_cam, prob.lobs_ln, _mv(Vlinv, bl))) * mfree

    # the exact block diagonal of S: B_o = Jc_o^T W_o Jl_o per observation
    B = JcW.mT @ Jp                                   # (O, 6, 3)
    Bl = JclW.mT @ Jl                                 # (OL, 6, 6)
    dg = _block_sum(C, prob.obs_cam, (B @ Vinv[prob.obs_pt]) @ B.mT).index_add_(
        0, prob.lobs_cam, (Bl @ Vlinv[prob.lobs_ln]) @ Bl.mT)
    M = (Ud - dg) * mfree[:, :, None] + eye6 * (1.0 - mfree[:, :, None]) + 1e-6 * eye6
    Minv = torch.linalg.inv_ex(M)[0]

    def prec(v):
        return _mv(Minv, v) * mfree

    # ---- PCG, a fixed number of iterations ----------------------------
    tiny = torch.full((), 1e-20, dtype=dt, device=cam_R.device)
    x = torch.zeros(C, 6, dtype=dt, device=cam_R.device)
    res = bt
    z = prec(res)
    p = z
    rz = (res * z).sum()
    for _ in range(cg_iters):
        Ap = S_mul(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp.abs() > 1e-20, pAp, tiny)
        ok = pAp > 1e-20
        x = torch.where(ok, x + alpha * p, x)
        res = torch.where(ok, res - alpha * Ap, res)
        z = prec(res)
        rzn = (res * z).sum()
        beta = rzn / torch.where(rz.abs() > 1e-20, rz, tiny)
        p = torch.where(ok, z + beta * p, p)
        rz = rzn
    xi = x * mfree

    # ---- back-substitution -------------------------------------------
    dX = _mv(Vinv, bp - at_v(JcW, Jp, prob.obs_cam, prob.obs_pt, P, xi))
    dE = _mv(Vlinv, bl - at_v(JclW, Jl, prob.lobs_cam, prob.lobs_ln, L, xi))
    Rn, tn = se3.left_update(xi, cam_R, cam_t)
    Rn = se3.orthonormalize(Rn)
    keep = prob.cam_fixed | ~prob.cam_valid
    tn = torch.where(keep[:, None], cam_t, tn)
    Rn = torch.where(keep[:, None, None], cam_R, Rn)
    has_obs_p = torch.diagonal(V, dim1=-2, dim2=-1).sum(-1) > 1e-9
    Xn = torch.where((prob.pt_valid & has_obs_p)[:, None], pt_xyz + dX, pt_xyz)
    has_obs_l = torch.diagonal(Vl, dim1=-2, dim2=-1).sum(-1) > 1e-9
    En = torch.where((prob.ln_valid & has_obs_l)[:, None, None], ln_ep + dE.reshape(L, 2, 3),
                     ln_ep)

    cost0 = _robust_cost(cam, prob, cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, use_robust)
    cost1 = _robust_cost(cam, prob, Rn, tn, Xn, En, in_pt, in_ln, use_robust)
    accept = (cost1 < cost0) & torch.isfinite(cost1)
    cam_R = torch.where(accept, Rn, cam_R)
    cam_t = torch.where(accept, tn, cam_t)
    pt_xyz = torch.where(accept, Xn, pt_xyz)
    ln_ep = torch.where(accept, En, ln_ep)
    lam = torch.where(accept, lam * 0.3, lam * 5.0).clamp(1e-9, 1e6)
    return (cam_R, cam_t, pt_xyz, ln_ep, in_pt, in_ln, lam)


def ba_iterate_chunk_cg(cam, prob: BAProblem, state, robust: bool = True, n: int = 5,
                        cg_iters: int = 48):
    """``n`` matrix-free LM iterations, enqueued with no host sync between
    them (the CG counterpart of ``local_ba.ba_iterate_chunk``)."""
    for _ in range(n):
        state = _lm_iteration_cg(cam, prob, state, robust, cg_iters)
    return state


def bundle_adjust_cg_stepped(cam, prob: BAProblem, iters1: int = 5, iters2: int = 10,
                             robust: bool = True, should_abort=None,
                             cg_iters: int = 48) -> BAResult:
    """Two-phase LM BA with the matrix-free PCG inner solver, solved in
    ``local_ba.SOLVE_DTYPE``: the drop-in for
    ``local_ba.bundle_adjust_stepped`` at global-BA scale, with the same
    chunks of 5 iterations and ``should_abort()`` polled between them.
    ``bundle_adjust_cg_stepped.runs`` counts calls."""
    bundle_adjust_cg_stepped.runs += 1
    dtype = prob.cam_R.dtype
    prob = local_ba._astype(prob, local_ba.SOLVE_DTYPE)
    state = local_ba.ba_state_init(prob)
    aborted = False
    chunk = 5
    for i in range(0, iters1, chunk):
        state = ba_iterate_chunk_cg(cam, prob, state, robust, n=min(chunk, iters1 - i),
                                    cg_iters=cg_iters)
        if should_abort is not None and should_abort():
            aborted = True
            break
    if not aborted:
        state = local_ba.ba_reclassify(cam, prob, state)
        for i in range(0, iters2, chunk):
            state = ba_iterate_chunk_cg(cam, prob, state, robust, n=min(chunk, iters2 - i),
                                        cg_iters=cg_iters)
            if should_abort is not None and should_abort():
                break
    return local_ba._astype(local_ba.ba_finalize(cam, prob, state), dtype)


bundle_adjust_cg_stepped.runs = 0
