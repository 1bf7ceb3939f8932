"""Trajectory evaluation: TUM-protocol ATE / RPE.

A copy of the JAX package's ``utils/evaluate.py``, the stand-in for the
TUM RGB-D benchmark's ``evaluate_ate.py`` (the tool the reference's
trajectories are scored with): timestamp association between estimate and ground
truth, closed-form Umeyama/Horn alignment, RMSE of the aligned translation
residuals. Pure numpy — it runs on trajectory files, not device arrays.
"""

from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics):
    all (i, j) pairs with |ts_a[i] - ts_b[j]| <= max_dt, each index used at
    most once, closest pairs first."""
    pairs = []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        dt = abs(float(ts_b[j] - ta))
        if dt <= max_dt:
            pairs.append((dt, i, j))
    pairs.sort()
    used_a: set[int] = set()
    used_b: set[int] = set()
    out = []
    for _, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    out.sort()
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Closed-form similarity aligning src -> dst (Umeyama 1991).
    Returns (s, R, t) with dst ≈ s * R @ src + t."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(gt_ts, gt_pos, est_ts, est_pos, *, max_dt: float = 0.02,
             with_scale: bool = False):
    """Absolute trajectory error RMSE after timestamp association and
    rigid (or, for monocular, similarity) alignment.

    Returns (rmse, n_pairs, stats) where stats has mean/median/max."""
    gt_ts = np.asarray(gt_ts, np.float64)
    est_ts = np.asarray(est_ts, np.float64)
    gt_pos = np.asarray(gt_pos, np.float64)
    est_pos = np.asarray(est_pos, np.float64)
    pairs = associate(est_ts, gt_ts, max_dt)
    if len(pairs) < 2:
        return float("nan"), 0, {}
    ei = np.array([i for i, _ in pairs])
    gj = np.array([j for _, j in pairs])
    s, R, t = umeyama_alignment(est_pos[ei], gt_pos[gj], with_scale)
    aligned = s * est_pos[ei] @ R.T + t
    err = np.linalg.norm(aligned - gt_pos[gj], axis=1)
    rmse = float(np.sqrt((err**2).mean()))
    stats = {
        "mean": float(err.mean()), "median": float(np.median(err)),
        "max": float(err.max()), "scale": s,
    }
    return rmse, len(pairs), stats


def trajectory_positions(traj):
    """(ts, pos) arrays from a tracker-style [(ts, R_cw, t_cw), ...] list
    (positions are camera centers in world frame)."""
    ts = np.array([e[0] for e in traj], np.float64)
    pos = np.array([-(R.T @ t) for _, R, t in traj], np.float64)
    return ts, pos
