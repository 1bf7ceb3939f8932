"""Pose-graph optimization over keyframes (the essential graph).

The port of the JAX package's ``optim/pose_graph.py``, the counterpart of
``Optimizer::OptimizeEssentialGraph`` (Optimizer.cc:1064-1399): nodes are
keyframe poses, edges relative-pose measurements (spanning tree, strong
covisibility, loop connections, loop edges), and the residual of edge
(i, j) is ``log(T_ij_meas^-1 ∘ T_i ∘ T_j^-1)``.

- SE(3) (``optimize_pose_graph``): RGB-D and stereo, where the scale is
  observable (the reference's fix_scale=true path).
- Sim(3) (``optimize_pose_graph_sim3``): 7-dof nodes that absorb monocular
  scale drift (fix_scale=false).

Damped Gauss-Newton on fixed padded shapes: per-edge residuals and their
Jacobians for left perturbations of either node (forward-mode
``torch.func.jvp`` along each tangent direction, batched over the edges and
the directions by ``torch.func.vmap``, as the JAX package's vmapped
``jacfwd``), the normal equations scattered into one dense (6K, 6K) or
(7K, 7K) system with ``index_add_``, fixed and invalid nodes masked to
identity rows, ``lam * diag + 1e-8 I`` damping, solved with
``torch.linalg.solve_ex`` in the problem's dtype (float32, as the JAX
package). The accept test and the damping update are ``torch.where`` on the
device, so an iteration reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, sim3


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor        # (K, 3, 3) current poses (world -> camera)
    t: torch.Tensor        # (K, 3)
    fixed: torch.Tensor    # (K,) bool; the loop keyframe anchors the gauge
    valid: torch.Tensor    # (K,) bool
    ei: torch.Tensor       # (E,) int64
    ej: torch.Tensor       # (E,) int64
    R_meas: torch.Tensor   # (E, 3, 3) measured T_ij = T_i ∘ T_j^-1
    t_meas: torch.Tensor   # (E, 3)
    w: torch.Tensor        # (E,) edge weight
    e_valid: torch.Tensor  # (E,) bool


class Sim3GraphProblem(NamedTuple):
    R: torch.Tensor        # (K, 3, 3)
    t: torch.Tensor        # (K, 3)
    s: torch.Tensor        # (K,) scale of the world -> camera similarity
    fixed: torch.Tensor
    valid: torch.Tensor
    ei: torch.Tensor
    ej: torch.Tensor
    R_meas: torch.Tensor   # (E, 3, 3) measured S_ij = S_i ∘ S_j^-1
    t_meas: torch.Tensor
    s_meas: torch.Tensor   # (E,)
    w: torch.Tensor
    e_valid: torch.Tensor


def _zeros_problem(K, E, device):
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    eye = torch.eye(3, **f32)
    return dict(R=eye.expand(K, 3, 3).clone(), t=torch.zeros(K, 3, **f32),
                fixed=torch.zeros(K, dtype=torch.bool, device=dev),
                valid=torch.zeros(K, dtype=torch.bool, device=dev),
                ei=torch.zeros(E, dtype=torch.int64, device=dev),
                ej=torch.zeros(E, dtype=torch.int64, device=dev),
                R_meas=eye.expand(E, 3, 3).clone(), t_meas=torch.zeros(E, 3, **f32),
                w=torch.ones(E, **f32), e_valid=torch.zeros(E, dtype=torch.bool, device=dev))


def make_problem(K: int, E: int, device="cuda") -> PoseGraphProblem:
    return PoseGraphProblem(**_zeros_problem(K, E, device))


def make_sim3_problem(K: int, E: int, device="cuda") -> Sim3GraphProblem:
    d = _zeros_problem(K, E, device)
    return Sim3GraphProblem(s=torch.ones(K, dtype=torch.float32, device=d["R"].device),
                            s_meas=torch.ones(E, dtype=torch.float32, device=d["R"].device),
                            **d)


def relative_pose(Ri, ti, Rj, tj):
    """T_ij = T_i ∘ T_j^-1."""
    Rji, tji = se3.inverse(Rj, tj)
    return se3.compose(Ri, ti, Rji, tji)


def _residual_and_jacobians(res, zero):
    """``res(xi_i, xi_j)`` -> (E, m) at xi = 0, and its Jacobians (E, m, n)
    with respect to the left perturbations xi_i and xi_j (E, n): one
    forward-mode pass per tangent direction, all directions in one vmap."""
    n = zero.shape[-1]
    basis = torch.eye(n, dtype=zero.dtype, device=zero.device)[:, None, :].expand(
        n, *zero.shape)

    def cols(f):
        return torch.func.vmap(lambda v: torch.func.jvp(f, (zero,), (v,))[1])(basis)

    Ji = cols(lambda x: res(x, zero)).permute(1, 2, 0)
    Jj = cols(lambda x: res(zero, x)).permute(1, 2, 0)
    return res(zero, zero), Ji, Jj


def _gn_step(prob, r, Ji, Jj, lam):
    """The damped normal equations of one Gauss-Newton step, solved:
    returns the per-node update (K, n), 0 on fixed and invalid nodes."""
    K = prob.R.shape[0]
    n = Ji.shape[-1]
    ei, ej = prob.ei, prob.ej
    w = (prob.w * prob.e_valid)[:, None, None]
    JiW, JjW = Ji * w, Jj * w
    H = torch.zeros(K * K, n, n, dtype=r.dtype, device=r.device)
    H.index_add_(0, ei * K + ei, JiW.mT @ Ji)
    H.index_add_(0, ej * K + ej, JjW.mT @ Jj)
    H.index_add_(0, ei * K + ej, JiW.mT @ Jj)
    H.index_add_(0, ej * K + ei, JjW.mT @ Ji)
    H = H.view(K, K, n, n)
    b = torch.zeros(K, n, dtype=r.dtype, device=r.device)
    b.index_add_(0, ei, -(JiW.mT @ r[..., None])[..., 0])
    b.index_add_(0, ej, -(JjW.mT @ r[..., None])[..., 0])
    mc = (prob.valid & ~prob.fixed).to(r.dtype)
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    H = H * mc[:, None, None, None] * mc[None, :, None, None]
    idx = torch.arange(K, device=r.device)
    H[idx, idx] += eye * (1.0 - mc)[:, None, None]
    b = b * mc[:, None]
    Hd = H.permute(0, 2, 1, 3).reshape(n * K, n * K)
    Hd = Hd + lam * torch.diag(torch.diagonal(Hd)) \
        + 1e-8 * torch.eye(n * K, dtype=r.dtype, device=r.device)
    return torch.linalg.solve_ex(Hd, b.reshape(-1))[0].reshape(K, n)


def _accept(c0, c1, lam):
    accept = (c1 < c0) & torch.isfinite(c1)
    return accept, torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e3)


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20):
    """Damped Gauss-Newton on the SE(3) edge residuals. Returns (R, t)."""
    ei, ej = prob.ei, prob.ej
    w = prob.w * prob.e_valid
    keep = ~(prob.valid & ~prob.fixed)
    Rm_inv, tm_inv = se3.inverse(prob.R_meas, prob.t_meas)

    def residual_fn(R, t):
        Ri, ti, Rj, tj = R[ei], t[ei], R[ej], t[ej]

        def res(xi_i, xi_j):
            Ri2, ti2 = se3.left_update(xi_i, Ri, ti)
            Rj2, tj2 = se3.left_update(xi_j, Rj, tj)
            Rrel, trel = relative_pose(Ri2, ti2, Rj2, tj2)
            return se3.se3_log(*se3.compose(Rm_inv, tm_inv, Rrel, trel))
        return res

    def cost(R, t):
        zero = torch.zeros(ei.shape[0], 6, dtype=R.dtype, device=R.device)
        return ((residual_fn(R, t)(zero, zero) ** 2).sum(-1) * w).sum()

    R, t = prob.R, prob.t
    lam = torch.tensor(1e-6, dtype=R.dtype, device=R.device)
    zero = torch.zeros(ei.shape[0], 6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        r, Ji, Jj = _residual_and_jacobians(residual_fn(R, t), zero)
        xi = _gn_step(prob, r, Ji, Jj, lam)
        Rn, tn = se3.left_update(xi, R, t)
        Rn = se3.orthonormalize(Rn)
        tn = torch.where(keep[:, None], t, tn)
        Rn = torch.where(keep[:, None, None], R, Rn)
        accept, lam = _accept(cost(R, t), cost(Rn, tn), lam)
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
    return R, t


def optimize_pose_graph_sim3(prob: Sim3GraphProblem, iters: int = 20):
    """Damped Gauss-Newton over Sim(3) nodes. Returns (R, t, s)."""
    ei, ej = prob.ei, prob.ej
    w = prob.w * prob.e_valid
    keep = ~(prob.valid & ~prob.fixed)
    sm_inv, Rm_inv, tm_inv = sim3.inverse(prob.s_meas, prob.R_meas, prob.t_meas)

    def upd(xi, s, R, t):
        return sim3.compose(*sim3.exp(xi), s, R, t)

    def residual_fn(s, R, t):
        si, Ri, ti, sj, Rj, tj = s[ei], R[ei], t[ei], s[ej], R[ej], t[ej]

        def res(xi_i, xi_j):
            Si = upd(xi_i, si, Ri, ti)
            Sj_inv = sim3.inverse(*upd(xi_j, sj, Rj, tj))
            Srel = sim3.compose(*Si, *Sj_inv)
            return sim3.log(*sim3.compose(sm_inv, Rm_inv, tm_inv, *Srel))
        return res

    def cost(s, R, t):
        zero = torch.zeros(ei.shape[0], 7, dtype=R.dtype, device=R.device)
        return ((residual_fn(s, R, t)(zero, zero) ** 2).sum(-1) * w).sum()

    R, t, s = prob.R, prob.t, prob.s
    lam = torch.tensor(1e-6, dtype=R.dtype, device=R.device)
    zero = torch.zeros(ei.shape[0], 7, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        r, Ji, Jj = _residual_and_jacobians(residual_fn(s, R, t), zero)
        xi = _gn_step(prob, r, Ji, Jj, lam)
        sn, Rn, tn = upd(xi, s, R, t)
        Rn = se3.orthonormalize(Rn)
        sn = torch.where(keep, s, sn)
        tn = torch.where(keep[:, None], t, tn)
        Rn = torch.where(keep[:, None, None], R, Rn)
        accept, lam = _accept(cost(s, R, t), cost(sn, Rn, tn), lam)
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        s = torch.where(accept, sn, s)
    return R, t, s
