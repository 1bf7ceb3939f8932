"""Dry run of the sharded map refinement, the port of the JAX package's
``parallel/dryrun.py``.

    python -m plslam_torch.parallel.dryrun --shards N [--device cpu]

Four phases, each on ``N`` shards of one device (``[device] * N``), the
counterpart of the JAX package's N virtual devices:

1. one pose Gauss-Newton step over a ``(dp, obs)`` mesh: a cohort of
   keyframes split over ``dp``, each keyframe's observations over ``obs``;
   the 6x6 normal equations of each keyframe are summed over ``obs`` (the
   collective of the distributed Schur BA) and solved per keyframe;
2. one step of the sharded BA with the dense reduced camera system
   (``parallel.ba.distributed_gn_step``) on a small problem;
3. one step of the matrix-free sharded PCG (``distributed_cg_step``);
4. the engine's own global BA: ``LocalMapper.run_local_ba`` on a 72-keyframe
   ``make_synthetic_ba_map`` routed through the mesh, which must land the
   keyframes within 2 cm of the ground truth on average.

``run`` returns the phases' numbers as a dict; the module prints it as one
JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..geometry import se3
from ..geometry.projection import Camera
from ..optim.local_ba import _pt_jacobians, _pt_residual
from . import ba as pba
from .mesh import make_ba_mesh, make_mesh

_DRY_CAM = Camera(fx=525.0, fy=525.0, cx=320.0, cy=240.0, bf=0.0)


def _pose_gn_step(p3d, uv, w, R, t):
    """One keyframe pose's normal equations (H (..., 6, 6), b (..., 6)) over
    its observations p3d (..., N, 3), uv (..., N, 2), weights w (..., N),
    for a pose (R (..., 3, 3), t (..., 3)) and the left perturbation."""
    shape = p3d.shape[:-1]
    N = shape[-1]
    Rb = R[..., None, :, :].expand(*shape, 3, 3).reshape(-1, 3, 3)
    tb = t[..., None, :].expand(*shape, 3).reshape(-1, 3)
    X = p3d.reshape(-1, 3)
    ur = torch.full(X.shape[:1], -1.0, dtype=X.dtype, device=X.device)
    r = _pt_residual(_DRY_CAM, Rb, tb, X, uv.reshape(-1, 2), ur)[:, :2]
    J = _pt_jacobians(_DRY_CAM, Rb, tb, X, ur)[0][:, :2]     # (M, 2, 6)
    Jw = J * w.reshape(-1)[:, None, None]
    lead = shape[:-1]
    H = (Jw.mT @ J).reshape(*lead, N, 6, 6).sum(-3)
    b = -(Jw.mT @ r[..., None])[..., 0].reshape(*lead, N, 6).sum(-2)
    return H, b


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_devices: int, device="cuda") -> dict:
    """The four phases on ``n_devices`` shards of ``device``."""
    dev = torch.device(device)
    out = {"shards": n_devices, "device": str(dev)}
    rng = np.random.default_rng(0)

    # ---- phase 1: the (dp, obs) pose-GN step
    t0 = time.perf_counter()
    mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    dp, obs = mesh.shape["dp"], mesh.shape["obs"]
    B = dp * 2          # keyframes in the cohort
    N = obs * 16        # observations per keyframe (sharded over obs)
    p3d = rng.uniform(-1, 1, (B, N, 3)) + [0, 0, 3.0]
    uv = rng.uniform(0, 480, (B, N, 2))
    f32 = dict(dtype=torch.float32, device=dev)
    p3d, uv = torch.as_tensor(p3d, **f32), torch.as_tensor(uv, **f32)
    w = torch.ones(B, N, **f32)
    R = torch.eye(3, **f32).expand(B, 3, 3)
    t = torch.zeros(B, 3, **f32)
    kb = B // dp
    Rn, tn = [], []
    for d in range(dp):
        row = mesh.row(d)
        ks = slice(d * kb, (d + 1) * kb)
        # (obs shard, keyframe, observation) stacks of this dp row's cohort
        shard = lambda x: x[ks].unflatten(1, (obs, -1)).transpose(0, 1)  # noqa: E731
        H_parts, b_parts = [], []
        for rdev, a, b_ in row.runs:
            H, b = _pose_gn_step(shard(p3d)[a:b_].to(rdev), shard(uv)[a:b_].to(rdev),
                                 shard(w)[a:b_].to(rdev), R[ks].to(rdev), t[ks].to(rdev))
            H_parts.append(H)
            b_parts.append(b)
        H, b = row.psum(H_parts), row.psum(b_parts)
        xi = torch.linalg.solve(H + 1e-3 * torch.eye(6, **f32), b)
        Rk, tk = se3.left_update(xi, R[ks], t[ks])
        Rn.append(Rk)
        tn.append(tk)
    Rn, tn = torch.cat(Rn), torch.cat(tn)
    if Rn.shape != (B, 3, 3) or tn.shape != (B, 3) or not torch.isfinite(tn).all():
        raise AssertionError(f"pose step gave {tuple(Rn.shape)} {tuple(tn.shape)}")
    _sync(dev)
    out["pose_step"] = dict(dp=dp, obs=obs, keyframes=B, observations=N,
                            seconds=time.perf_counter() - t0)

    # ---- phase 2: the sharded BA step with the dense camera system
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0)
    n_pts = n_devices * 8
    n_cams = 3
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32) + [0, 0, 3.0]
    cam_R = np.broadcast_to(np.eye(3, dtype=np.float32), (n_cams, 3, 3)).copy()
    cam_t = np.zeros((n_cams, 3), np.float32)
    cam_t[:, 0] = 0.05 * np.arange(n_cams)
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    pc = np.einsum("oij,oj->oi", cam_R[obs_cam], pts[obs_pt]) + cam_t[obs_cam]
    obs_uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240],
                      -1).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    prob = pba.shard_problem(
        cam_R, cam_t, fixed, pts, np.ones(n_pts, bool), obs_cam, obs_pt, obs_uv,
        np.full(len(obs_cam), -1.0, np.float32), np.ones(len(obs_cam), np.float32),
        np.ones(len(obs_cam), bool), n_shards=n_devices)
    ba_mesh = make_ba_mesh([dev] * n_devices)
    for name, step, kw in (("gn_step", pba.distributed_gn_step, {}),
                           ("cg_step", pba.distributed_cg_step, dict(cg_iters=8))):
        t0 = time.perf_counter()
        Rb, tb, Xb = step(cam, prob, ba_mesh, **kw)
        _sync(dev)
        if Rb.shape != (n_cams, 3, 3) or not torch.isfinite(Xb).all():
            raise AssertionError(f"{name} gave {tuple(Rb.shape)}")
        out[name] = dict(cameras=n_cams, points=n_pts, seconds=time.perf_counter() - t0)

    # ---- phase 4: the engine's own global BA routed through the mesh
    from ..config import SlamConfig
    from ..models.local_mapping import LocalMapper
    from ..utils.synthetic import make_synthetic_ba_map

    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, use_distributed_ba=True, distributed_ba_iters=4))
    slam_map, gt_poses, _ = make_synthetic_ba_map(cfg, n_kf=72, n_pts=200, obs_per_kf=48,
                                                  seed=1, device=dev)
    mapper = LocalMapper(cfg, slam_map)
    mapper.ba_mesh = ba_mesh
    t0 = time.perf_counter()
    solver = mapper.run_local_ba(0, window=128, obs_cap=1 << 13, point_cap=256)
    seconds = time.perf_counter() - t0
    errs = [np.linalg.norm(-(slam_map.kf_R[k].T @ slam_map.kf_t[k]) - (-(Rgt.T @ tgt)))
            for k, (Rgt, tgt) in enumerate(gt_poses) if slam_map.kf_valid[k]]
    mean_err = float(np.mean(errs))
    if solver != "distributed" or not mean_err < 0.02:
        raise AssertionError(f"engine GBA: solver {solver}, mean keyframe error {mean_err}")
    out["engine_gba"] = dict(solver=solver, keyframes=72, mean_kf_err_cm=mean_err * 100,
                             seconds=seconds)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m plslam_torch.parallel.dryrun")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.shards, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
