"""Distributed bundle adjustment: landmark-block sharding and a reduced
camera system summed over the shards, the port of the JAX package's
``parallel/ba.py``.

Map points (and their observations) are partitioned round-robin into
landmark shards. Every shard Schur-eliminates its landmark blocks locally;
the contributions to the reduced camera system S = U - sum_p A_p V_p^-1
A_p^T and its right-hand side are summed over the mesh's ``obs`` axis
(``BAMesh.psum``: the shard stack of each device, then the devices of the
process, then an ``all_reduce`` over the process group); the camera solve
is replicated and the landmark back-substitution stays on the shard. The
camera update is the same on every process by construction.

The shards of one device are one stack with the shard axis leading, so S
shards on one device take one launch per operation, not S. Accumulation
is ``local_ba``'s sorted ``index_put_(accumulate=True)``, reproducible on
the card. Residuals and analytic Jacobians are ``local_ba``'s (the JAX
package differentiates the same residual in forward mode). The steps
solve in ``local_ba.SOLVE_DTYPE`` (float64), as the port's other BA
solvers do, and return the dtype they were given;
``distributed_bundle_adjust`` returns float32.

The reference (Optimizer.cc:60-374 GlobalBundleAdjustemnt, :644-1063
LocalBundleAdjustment) has no distributed analog: its threads share one
address space.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..optim.local_ba import SOLVE_DTYPE, _block_sum, _damp, _pt_jacobians
from ..optim.local_ba import _pt_residual as _point_residual
from .mesh import BAMesh

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class ShardedBA(NamedTuple):
    """Per-shard BA problem; leading axis = shard. Cameras replicated.
    ``shard_problem`` gives host numpy arrays of every shard; ``place``
    gives tensors of this process's shards on the mesh's first device."""

    cam_R: np.ndarray      # (C, 3, 3) replicated
    cam_t: np.ndarray      # (C, 3)
    cam_fixed: np.ndarray  # (C,)
    pt_xyz: np.ndarray     # (S, Ps, 3) sharded points
    pt_valid: np.ndarray   # (S, Ps)
    obs_cam: np.ndarray    # (S, Os)
    obs_pt: np.ndarray     # (S, Os) local point index within the shard
    obs_uv: np.ndarray     # (S, Os, 2)
    obs_ur: np.ndarray     # (S, Os)
    obs_w: np.ndarray      # (S, Os)
    obs_valid: np.ndarray  # (S, Os)


SHARDED = ShardedBA._fields[3:]


def shard_problem(cam_R, cam_t, cam_fixed, pt_xyz, pt_valid,
                  obs_cam, obs_pt, obs_uv, obs_ur, obs_w, obs_valid,
                  n_shards: int) -> ShardedBA:
    """Host-side partitioner: round-robin points to shards, observations
    follow their point. Pads every shard to equal size."""
    P_total = pt_xyz.shape[0]
    owner = np.arange(P_total) % n_shards
    local_idx = np.arange(P_total) // n_shards
    Ps = -(-P_total // n_shards)
    o_owner = owner[obs_pt]
    per_shard_obs = [np.nonzero((o_owner == s) & obs_valid)[0] for s in range(n_shards)]
    Os = max(1, max(len(sel) for sel in per_shard_obs))

    sp_xyz = np.zeros((n_shards, Ps, 3), np.float32)
    sp_valid = np.zeros((n_shards, Ps), bool)
    so_cam = np.zeros((n_shards, Os), np.int32)
    so_pt = np.zeros((n_shards, Os), np.int32)
    so_uv = np.zeros((n_shards, Os, 2), np.float32)
    so_ur = np.full((n_shards, Os), -1.0, np.float32)
    so_w = np.ones((n_shards, Os), np.float32)
    so_valid = np.zeros((n_shards, Os), bool)
    for s in range(n_shards):
        pids = np.nonzero(owner == s)[0]
        sp_xyz[s, : len(pids)] = pt_xyz[pids]
        sp_valid[s, : len(pids)] = pt_valid[pids]
        sel = per_shard_obs[s]
        so_cam[s, : len(sel)] = obs_cam[sel]
        so_pt[s, : len(sel)] = local_idx[obs_pt[sel]]
        so_uv[s, : len(sel)] = obs_uv[sel]
        so_ur[s, : len(sel)] = obs_ur[sel]
        so_w[s, : len(sel)] = obs_w[sel]
        so_valid[s, : len(sel)] = True
    return ShardedBA(np.asarray(cam_R), np.asarray(cam_t), np.asarray(cam_fixed),
                     sp_xyz, sp_valid, so_cam, so_pt, so_uv, so_ur, so_w, so_valid)


def unshard_points(Xs: np.ndarray, n_points: int) -> np.ndarray:
    """Invert shard_problem's round-robin point partition: (S, Ps, 3) back
    to global (n_points, 3) order."""
    S, Ps, _ = Xs.shape
    out = np.zeros((n_points, 3), Xs.dtype)
    ids = np.arange(n_points)
    out[ids] = Xs[ids % S, ids // S]
    return out


def place(prob: ShardedBA, mesh: BAMesh, dtype=SOLVE_DTYPE) -> ShardedBA:
    """``prob`` as tensors on ``mesh.devices[0]``, floats in ``dtype``,
    indices int64: the cameras, and the stack of this process's shards
    (from a problem that holds every shard of the mesh, or only this
    process's). A placed problem in ``dtype`` is returned as it is."""
    dev = mesh.devices[0]

    def to(x, sharded):
        x = torch.as_tensor(x)
        if sharded:
            if x.shape[0] == mesh.n_shards:
                off = mesh.rank * mesh.n_local
            elif x.shape[0] == mesh.n_local:
                off = 0
            else:
                raise ValueError(f"{x.shape[0]} shards for a mesh of {mesh.n_shards}")
            x = x[off: off + mesh.n_local]
        if x.is_floating_point():
            return x.to(dev, dtype)
        return x.to(dev, torch.int64 if x.dtype in (torch.int32, torch.int64) else x.dtype)

    return ShardedBA(*(to(x, name in SHARDED) for name, x in zip(ShardedBA._fields, prob)))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class _Run(NamedTuple):
    """One run of shards on one device, linearized at the current state."""

    dev: torch.device
    pt_xyz: torch.Tensor    # (s, Ps, 3)
    pt_valid: torch.Tensor  # (s, Ps)
    ci: torch.Tensor        # (s * Os,) shard * C + camera
    oc: torch.Tensor        # (s * Os,) camera
    op: torch.Tensor        # (s * Os,) shard * Ps + point
    r: torch.Tensor         # (s * Os, 3)
    Jc: torch.Tensor        # (s * Os, 3, 6)
    Jp: torch.Tensor        # (s * Os, 3, 3)
    JcW: torch.Tensor
    JpW: torch.Tensor


def _runs(cam, prob: ShardedBA, mesh: BAMesh) -> list[_Run]:
    """Residuals and Jacobians of every observation, per run of shards."""
    C = prob.cam_R.shape[0]
    out = []
    for dev, a, b in mesh.runs:
        X, pv, oc, op, uv, ur, w, valid = (getattr(prob, f)[a:b].to(dev) for f in SHARDED)
        s, Ps = X.shape[:2]
        Os = oc.shape[1]
        sid = torch.arange(s, device=dev).repeat_interleave(Os)
        oc, op = oc.reshape(-1), sid * Ps + op.reshape(-1)
        R, t = prob.cam_R.to(dev)[oc], prob.cam_t.to(dev)[oc]
        Xo = X.reshape(-1, 3)[op]
        ur = ur.reshape(-1)
        r = _point_residual(cam, R, t, Xo, uv.reshape(-1, 2), ur)
        Jc, Jp = _pt_jacobians(cam, R, t, Xo, ur)
        wt = (w * valid).reshape(-1)[:, None, None]
        out.append(_Run(dev, X, pv, sid * C + oc, oc, op, r, Jc, Jp, Jc * wt, Jp * wt))
    return out


def _diag_blocks(run: _Run, C: int):
    """Per-shard U (s, C, 6, 6), V (s, Ps, 3, 3), bc (s, C, 6), bp (s, Ps, 3)."""
    s, Ps = run.pt_xyz.shape[:2]
    U = _block_sum(s * C, run.ci, run.JcW.mT @ run.Jc).view(s, C, 6, 6)
    V = _block_sum(s * Ps, run.op, run.JpW.mT @ run.Jp).view(s, Ps, 3, 3)
    bc = _block_sum(s * C, run.ci, -_mv(run.JcW.mT, run.r)).view(s, C, 6)
    bp = _block_sum(s * Ps, run.op, -_mv(run.JpW.mT, run.r)).view(s, Ps, 3)
    return U, V, bc, bp


def _update(prob: ShardedBA, xi, dXs, Vs, runs):
    """The cameras moved by ``xi`` (fixed ones kept), and every shard's
    points moved by its back-substitution where the point is valid and
    observed; the shard stack is joined on the first device."""
    Rn, tn = se3.left_update(xi, prob.cam_R, prob.cam_t)
    Rn = se3.orthonormalize(Rn)
    keep = prob.cam_fixed
    tn = torch.where(keep[:, None], prob.cam_t, tn)
    Rn = torch.where(keep[:, None, None], prob.cam_R, Rn)
    Xs = []
    for run, dX, V in zip(runs, dXs, Vs):
        has_obs = torch.diagonal(V, dim1=-2, dim2=-1).sum(-1) > 1e-9
        Xs.append(torch.where((run.pt_valid & has_obs)[..., None], run.pt_xyz + dX,
                              run.pt_xyz).to(prob.cam_R.device))
    return Rn, tn, Xs[0] if len(Xs) == 1 else torch.cat(Xs)


def _out_dtype(prob: ShardedBA):
    return torch.as_tensor(prob.cam_R).dtype


def distributed_gn_step(cam, prob: ShardedBA, mesh: BAMesh, lam: float = 1e-4):
    """One damped GN step of the sharded BA with the dense reduced camera
    system: one sum of the (C, C, 6, 6) system over the shards, then a
    replicated (6C, 6C) solve. Returns (cam_R, cam_t, pt_xyz), the points
    as this process's shard stack, in the dtype of ``prob``."""
    dtype = _out_dtype(prob)
    prob = place(prob, mesh)
    C = prob.cam_R.shape[0]
    runs = _runs(cam, prob, mesh)
    S_parts, bt_parts, U_parts, back = [], [], [], []
    for run in runs:
        s, Ps = run.pt_xyz.shape[:2]
        U, V, bc, bp = _diag_blocks(run, C)
        A = _block_sum(s * Ps * C, run.op * C + run.oc,
                       run.JcW.mT @ run.Jp).view(s, Ps, C, 6, 3)
        Vinv = torch.linalg.inv_ex(_damp(V, lam, 1e-6))[0]
        AV = torch.einsum("spcij,spjk->spcik", A, Vinv)
        S_parts.append(-torch.einsum("spcik,spdlk->scdil", AV, A))
        bt_parts.append(bc - torch.einsum("spcik,spk->sci", AV, bp))
        U_parts.append(U)
        back.append((A, Vinv, V, bp))

    # the collective: the camera system summed over the landmark shards
    S = mesh.psum(S_parts)
    bt = mesh.psum(bt_parts)
    Ud = _damp(mesh.psum(U_parts), lam, 0.0)
    dt, dev = S.dtype, S.device
    idx = torch.arange(C, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    S[idx, idx] += Ud
    mc = (~prob.cam_fixed).to(dt)
    S = S * mc[:, None, None, None] * mc[None, :, None, None]
    S[idx, idx] += eye6 * (1.0 - mc)[:, None, None]
    bt = bt * mc[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    xi = torch.linalg.solve_ex(Sd + 1e-8 * torch.eye(6 * C, dtype=dt, device=dev),
                               bt.reshape(-1))[0].reshape(C, 6)

    # landmark back-substitution, on each shard
    dXs, Vs = [], []
    for run, (A, Vinv, V, bp) in zip(runs, back):
        rhs = bp - torch.einsum("spcik,ci->spk", A, xi.to(run.dev))
        dXs.append(_mv(Vinv, rhs))
        Vs.append(V)
    return tuple(x.to(dtype) for x in _update(prob, xi, dXs, Vs, runs))


def distributed_cg_step(cam, prob: ShardedBA, mesh: BAMesh, lam: float = 1e-4,
                        cg_iters: int = 32):
    """One damped GN step with a matrix-free sharded Schur solve: every S v
    product is two passes over each shard's observations whose (C, 6)
    camera-vector contribution is summed over the shards, so each PCG
    iteration moves 6C numbers between processes and nothing quadratic in C
    exists; the preconditioner (the exact block diagonal of S) is one
    (C, 6, 6) sum. Returns (cam_R, cam_t, pt_xyz) as
    :func:`distributed_gn_step`."""
    dtype = _out_dtype(prob)
    prob = place(prob, mesh)
    C = prob.cam_R.shape[0]
    runs = _runs(cam, prob, mesh)
    blocks = [_diag_blocks(run, C) for run in runs]
    Vinvs = [torch.linalg.inv_ex(_damp(V, lam, 1e-6))[0].reshape(-1, 3, 3)
             for _, V, _, _ in blocks]
    Ud = _damp(mesh.psum([U for U, _, _, _ in blocks]), lam, 0.0)
    bc_all = mesh.psum([bc for _, _, bc, _ in blocks])
    dt, dev = Ud.dtype, Ud.device
    mfree = (~prob.cam_fixed).to(dt)[:, None]
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def at_v(run, v):
        """A^T v per point of the run's shards, (s * Ps, 3)."""
        u = _mv(run.JcW, v.to(run.dev)[run.oc])
        return _block_sum(run.pt_xyz.shape[0] * run.pt_xyz.shape[1], run.op,
                          _mv(run.Jp.mT, u))

    def a_z(run, z):
        """A z per camera of each of the run's shards, (s, C, 6)."""
        sv = _mv(run.Jp, z[run.op])
        return _block_sum(run.pt_xyz.shape[0] * C, run.ci,
                          _mv(run.JcW.mT, sv)).view(-1, C, 6)

    def S_mul(v):
        v = v * mfree
        t = mesh.psum([a_z(run, _mv(Vinv, at_v(run, v))) for run, Vinv in zip(runs, Vinvs)])
        return (_mv(Ud, v) - t) * mfree

    bt = (bc_all - mesh.psum([a_z(run, _mv(Vinv, bp.reshape(-1, 3)))
                              for run, Vinv, (_, _, _, bp) in zip(runs, Vinvs, blocks)])) * mfree

    # the exact block-diagonal preconditioner (one sum)
    dg = []
    for run, Vinv in zip(runs, Vinvs):
        B = run.JcW.mT @ run.Jp
        dg.append(_block_sum(run.pt_xyz.shape[0] * C, run.ci,
                             (B @ Vinv[run.op]) @ B.mT).view(-1, C, 6, 6))
    M = Ud - mesh.psum(dg)
    M = M * mfree[:, :, None] + eye6 * (1.0 - mfree[:, :, None])
    Minv = torch.linalg.inv_ex(M + 1e-6 * eye6)[0]

    def prec(v):
        return _mv(Minv, v) * mfree

    tiny = torch.full((), 1e-20, dtype=dt, device=dev)
    x = torch.zeros(C, 6, dtype=dt, device=dev)
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

    # landmark back-substitution, on each shard
    dXs = []
    for run, Vinv, (_, _, _, bp) in zip(runs, Vinvs, blocks):
        dX = _mv(Vinv, bp.reshape(-1, 3) - at_v(run, xi))
        dXs.append(dX.view(bp.shape))
    return tuple(x.to(dtype) for x in _update(prob, xi, dXs, [V for _, V, _, _ in blocks],
                                               runs))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def distributed_bundle_adjust(cam, prob, mesh: BAMesh, iters: int = 8, cg_iters: int = 32,
                              chi2_mono: float = CHI2_MONO, chi2_stereo: float = CHI2_STEREO,
                              should_abort=None):
    """Run the engine's gathered point-BA problem on a landmark-shard mesh.

    ``prob`` is the engine's ``optim.local_ba.BAProblem`` (its point fields
    are read; line fields are ignored: the reference's GBA is points-only,
    Optimizer.cc:60-374, and map lines ride along with their reference
    keyframes). The landmark blocks are round-robin sharded over the mesh;
    each damped GN step relinearizes and solves the reduced camera system
    with the matrix-free sharded PCG (:func:`distributed_cg_step`), and
    ``should_abort()`` is polled between steps (mbStopGBA,
    LoopClosing.cc:641-647).

    Returns (cam_R, cam_t, pt_xyz, obs_inlier) as float32 host numpy in the
    problem's global order, the chi2 inlier split at the final state: a
    drop-in for the single-device solvers' write-back.
    """
    cam_fixed = _host(prob.cam_fixed) | ~_host(prob.cam_valid)
    pt_xyz = _host(prob.pt_xyz)
    obs_cam, obs_pt = _host(prob.obs_cam), _host(prob.obs_pt)
    obs_uv, obs_ur = _host(prob.obs_uv), _host(prob.obs_ur)
    obs_w, obs_valid = _host(prob.obs_w), _host(prob.obs_valid)
    P_total = pt_xyz.shape[0]

    sharded = place(shard_problem(
        _host(prob.cam_R), _host(prob.cam_t), cam_fixed, pt_xyz, _host(prob.pt_valid),
        obs_cam, obs_pt, obs_uv, obs_ur, obs_w, obs_valid, n_shards=mesh.n_shards), mesh)
    lam = 1e-3
    for it in range(iters):
        # a queued keyframe aborts between steps: the abort latency is one
        # GN step, as in the single-device stepped BA
        if should_abort is not None and it > 0 and should_abort():
            break
        Rn, tn, Xn = distributed_cg_step(cam, sharded, mesh, lam=lam, cg_iters=cg_iters)
        sharded = sharded._replace(cam_R=Rn, cam_t=tn, pt_xyz=Xn)
        lam = max(lam * 0.5, 1e-5)

    Rn = _host(sharded.cam_R.float())
    tn = _host(sharded.cam_t.float())
    Xn = unshard_points(_host(mesh.all_gather(sharded.pt_xyz).float()), P_total)

    # chi2 inlier classification at the final state (host, vectorized): the
    # engine's write-back erases outlier observations
    pc = np.einsum("oij,oj->oi", Rn[obs_cam], Xn[obs_pt]) + tn[obs_cam]
    z = np.where(np.abs(pc[:, 2]) > 1e-6, pc[:, 2], 1e-6)
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    du = u - obs_uv[:, 0]
    dv = v - obs_uv[:, 1]
    stereo = obs_ur >= 0
    dur = np.where(stereo, (u - cam.bf / z) - obs_ur, 0.0)
    chi2 = obs_w * (du**2 + dv**2 + dur**2)
    inlier = obs_valid & (pc[:, 2] > 0) & np.where(stereo, chi2 <= chi2_stereo,
                                                    chi2 <= chi2_mono)
    return Rn, tn, Xn, inlier
