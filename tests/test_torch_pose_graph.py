"""plslam_torch.optim.pose_graph (the essential graph) against the JAX
package's ``optim/pose_graph.py``.

Graphs are those of ``tests/test_pose_graph.py`` (numpy-seeded), carried to
the port with ``convert.pose_graph_problem_from_numpy`` /
``convert.sim3_problem_from_numpy``; both packages solve in float32.

- SE(3): the 24-node circle with a drifted odometry chain and one true loop
  edge; poses equal JAX's to 1e-4 m / 1e-4 (rotation-matrix entries), the
  loop edge honoured as in the JAX test, the fixed node bitwise unchanged.
- Sim(3): the 8-node scale-drift circle; poses and scales equal JAX's to
  1e-4, scales pulled back to 1.
- The reference's ``bFixScale=false`` semantics (OptimizeEssentialGraph's
  7-dof vertices, Optimizer.cc:1064-1399): two sectors of one circle whose
  old half carries a 1.3 similarity tear, joined only by two loop edges
  that measure the true Sim(3) relative; the solve pulls both sectors onto
  one scale, the tear within 8% of 1 (ROADMAP Queue C's bar), and equals
  JAX's solve to 1e-4.
"""

import numpy as np
import torch

import jax.numpy as jnp

from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.geometry import sim3 as jsim3
from plslam_tpu.optim import pose_graph as jpg
from plslam_torch import convert
from plslam_torch.optim import pose_graph as tpg
from test_pose_graph import circle_poses
from torch_parity import few_torch_threads  # noqa: F401

TOL = 1e-4


def _solve_both(arrays, sim3=False, iters=30):
    """(JAX result, port result) as numpy tuples for one problem."""
    if sim3:
        jp = jpg.Sim3GraphProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jout = jpg.optimize_pose_graph_sim3(jp, iters=iters)
        tout = tpg.optimize_pose_graph_sim3(convert.sim3_problem_from_numpy(arrays, "cpu"),
                                            iters=iters)
    else:
        jp = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jout = jpg.optimize_pose_graph(jp, iters=iters)
        tout = tpg.optimize_pose_graph(convert.pose_graph_problem_from_numpy(arrays, "cpu"),
                                       iters=iters)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def _rel(Ri, ti, Rj, tj):
    Rr, tr = jpg.relative_pose(*(jnp.asarray(x) for x in (Ri, ti, Rj, tj)))
    return np.asarray(Rr), np.asarray(tr)


def _drift_graph():
    """tests/test_pose_graph.py::test_loop_drift_correction's graph."""
    rng = np.random.default_rng(0)
    n = 24
    gt = circle_poses(n)
    est = [gt[0]]
    for i in range(1, n):
        Rrel, trel = jpg.relative_pose(*(jnp.asarray(x) for x in
                                         (gt[i][0], gt[i][1], gt[i - 1][0], gt[i - 1][1])))
        xi = rng.standard_normal(6).astype(np.float32) * np.array([0.004] * 3 + [0.015] * 3,
                                                                  np.float32)
        Rn, tn = jse3.left_update(jnp.asarray(xi), Rrel, trel)
        Rp, tp = jse3.compose(Rn, tn, jnp.asarray(est[-1][0]), jnp.asarray(est[-1][1]))
        est.append((np.asarray(Rp), np.asarray(tp)))
    K = E = 32
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)).copy()
    t = np.zeros((K, 3), np.float32)
    for i, (Ri, ti) in enumerate(est):
        R[i], t[i] = Ri, ti
    valid = np.arange(K) < n
    fixed = np.arange(K) == 0
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    Rm = np.broadcast_to(np.eye(3, dtype=np.float32), (E, 3, 3)).copy()
    tm = np.zeros((E, 3), np.float32)
    w = np.zeros(E, np.float32)
    ev = np.zeros(E, bool)
    for i in range(1, n):
        ei[i - 1], ej[i - 1] = i, i - 1
        Rm[i - 1], tm[i - 1] = _rel(est[i][0], est[i][1], est[i - 1][0], est[i - 1][1])
        w[i - 1], ev[i - 1] = 1.0, True
    ei[n - 1], ej[n - 1] = n - 1, 0
    Rm[n - 1], tm[n - 1] = _rel(gt[n - 1][0], gt[n - 1][1], gt[0][0], gt[0][1])
    w[n - 1], ev[n - 1] = 5.0, True
    arrays = dict(R=R, t=t, fixed=fixed, valid=valid, ei=ei, ej=ej, R_meas=Rm, t_meas=tm,
                  w=w, e_valid=ev)
    return arrays, gt, est, n


def test_se3_graph_equals_jax():
    arrays, gt, est, n = _drift_graph()
    (jR, jt), (tR, tt) = _solve_both(arrays)
    np.testing.assert_allclose(tR, jR, atol=TOL)
    np.testing.assert_allclose(tt, jt, atol=TOL)
    # the JAX test's bars hold for the port's solution
    drift0 = np.linalg.norm(-est[-1][0].T @ est[-1][1] + gt[-1][0].T @ gt[-1][1])
    errs = [np.linalg.norm(-tR[i].T @ tt[i] + gt[i][0].T @ gt[i][1]) for i in range(n)]
    assert drift0 > 0.05
    assert errs[-1] < 0.35 * drift0 and np.mean(errs) < 0.6 * drift0
    # the fixed node and the padding rows do not move
    np.testing.assert_array_equal(tR[0], arrays["R"][0])
    np.testing.assert_array_equal(tt[0], arrays["t"][0])
    np.testing.assert_array_equal(tR[n:], arrays["R"][n:])
    np.testing.assert_array_equal(tt[n:], arrays["t"][n:])


def test_fixed_nodes_stay():
    """tests/test_pose_graph.py::test_fixed_nodes_stay, and a problem with
    no valid edge leaves every node where it was."""
    prob = tpg.make_problem(8, 8, device="cpu")._replace(
        valid=torch.ones(8, dtype=torch.bool), fixed=torch.arange(8) == 0)
    R, t = tpg.optimize_pose_graph(prob, iters=3)
    np.testing.assert_allclose(R[0].numpy(), np.eye(3), atol=1e-6)
    np.testing.assert_array_equal(R.numpy(), prob.R.numpy())
    np.testing.assert_array_equal(t.numpy(), prob.t.numpy())


def _scale_drift_graph():
    """tests/test_pose_graph.py::test_sim3_pose_graph_corrects_scale_drift."""
    K, E = 8, 16
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    gt_R, gt_t = [], []
    for a in angles:
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        c = np.array([np.cos(a), 0.0, np.sin(a)], np.float32) * 2.0
        gt_R.append(R)
        gt_t.append((-R @ c).astype(np.float32))
    gt_R, gt_t = np.stack(gt_R), np.stack(gt_t)
    est_s = (1.05 ** np.arange(K)).astype(np.float32)
    edges = [(k, k + 1) for k in range(K - 1)] + [(K - 1, 0)]
    arrays = _sim3_arrays(K, E, gt_R, gt_t * est_s[:, None], est_s, np.arange(K) == 0,
                          edges, [_sim3_rel(gt_R, gt_t, np.ones(K), i, j) for i, j in edges],
                          [1.0] * len(edges))
    return arrays, gt_R, gt_t


def _sim3_rel(R, t, s, i, j):
    """S_ij = S_i ∘ S_j^-1 of nodes (s, R, t), through the JAX package."""
    inv = jsim3.inverse(jnp.float32(s[j]), jnp.asarray(R[j]), jnp.asarray(t[j]))
    sr, Rr, tr = jsim3.compose(jnp.float32(s[i]), jnp.asarray(R[i]), jnp.asarray(t[i]), *inv)
    return float(sr), np.asarray(Rr), np.asarray(tr)


def _sim3_arrays(K, E, R, t, s, fixed, edges, meas, w):
    n = len(edges)
    pad = E - n
    ei = np.array([i for i, _ in edges] + [0] * pad, np.int32)
    ej = np.array([j for _, j in edges] + [0] * pad, np.int32)
    eye = np.eye(3, dtype=np.float32)
    return dict(
        R=R.astype(np.float32), t=t.astype(np.float32), s=s.astype(np.float32),
        fixed=np.asarray(fixed, bool), valid=np.ones(K, bool), ei=ei, ej=ej,
        R_meas=np.stack([m[1] for m in meas] + [eye] * pad).astype(np.float32),
        t_meas=np.stack([m[2] for m in meas] + [np.zeros(3, np.float32)] * pad)
        .astype(np.float32),
        s_meas=np.array([m[0] for m in meas] + [1.0] * pad, np.float32),
        w=np.array(list(w) + [0.0] * pad, np.float32),
        e_valid=np.arange(E) < n)


def test_sim3_graph_equals_jax():
    arrays, gt_R, gt_t = _scale_drift_graph()
    (jR, jt, js), (tR, tt, ts) = _solve_both(arrays, sim3=True)
    np.testing.assert_allclose(tR, jR, atol=TOL)
    np.testing.assert_allclose(tt, jt, atol=TOL)
    np.testing.assert_allclose(ts, js, atol=TOL)
    # the JAX test's bars
    assert np.abs(ts - 1.0).max() < 0.02
    assert np.abs(tt - gt_t).max() < 0.05
    assert np.abs(tR - gt_R).max() < 0.05
    np.testing.assert_array_equal(tR[0], arrays["R"][0])
    np.testing.assert_array_equal(ts[0], arrays["s"][0])


def _sector_ratio(R, t, s, gt_c, ks):
    """Median ratio of consecutive camera-centre distances (solution over
    ground truth) over nodes ``ks``: the sector's scale in the solution."""
    c = np.stack([-(R[k].T @ t[k]) / s[k] for k in ks])
    d = np.linalg.norm(np.diff(c, axis=0), axis=1)
    d0 = np.linalg.norm(np.diff(gt_c[ks], axis=0), axis=1)
    return float(np.median(d / d0))


def test_sim3_graph_heals_a_scale_tear():
    """bFixScale=false: the old sector (nodes 0-7) is displaced by a world
    similarity of scale 1.3 and stored scale-folded, [R W_R | (R W_t + t) /
    1.3], as the severed-map loop scenario leaves a monocular map; the new
    sector (8-15) sits at noisy ground truth. The sectors share no edge but
    two loop edges (15 -> 0 and 8 -> 7) measuring the true Sim(3) relative
    in the old sector's gauge (scale 1.3). Node 0, the loop keyframe, is
    fixed. The 7-dof solve brings the new sector onto the old sector's
    scale: the tear between the sectors' scales goes from 1.3 to within 8%
    of 1, and the port equals JAX."""
    rng = np.random.default_rng(3)
    K, E, s_tear = 16, 32, 1.3
    gt = circle_poses(K)
    gt_R = np.stack([R for R, _ in gt])
    gt_t = np.stack([t for _, t in gt]).astype(np.float32)
    gt_c = np.stack([-(R.T @ t) for R, t in gt])
    a = 0.10
    W_R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                   np.float32)
    W_t = np.array([0.15, 0.0, -0.12], np.float32)
    # every camera as a similarity in the old sector's gauge
    true_R = gt_R @ W_R
    true_t = (gt_R @ W_t + gt_t).astype(np.float32)
    true_s = np.full(K, s_tear, np.float32)
    R = true_R.copy()
    t = true_t.copy()
    s = np.ones(K, np.float32)
    t[:8] /= s_tear                               # the old sector, scale-folded SE3
    R[8:], t[8:] = gt_R[8:], gt_t[8:]             # the new sector, as tracked
    xi = rng.normal(0, 1, (8, 6)).astype(np.float32) * np.array([0.003] * 3 + [0.01] * 3,
                                                               np.float32)
    for k in range(8, K):
        Rn, tn = jse3.left_update(jnp.asarray(xi[k - 8]), jnp.asarray(R[k]), jnp.asarray(t[k]))
        R[k], t[k] = np.asarray(Rn), np.asarray(tn)
    # chain edges inside each sector, measured from the estimate (scale 1)
    edges = [(k + 1, k) for k in range(7)] + [(k + 1, k) for k in range(8, K - 1)]
    meas = [_sim3_rel(R, t, s, i, j) for i, j in edges]
    w = [1.0] * len(edges)
    # the loop edges: the true relative in the old gauge, S_i (new node:
    # scale 1.3, unfolded) ∘ S_j^-1 (old node: scale 1, folded)
    old_t = true_t / true_s[:, None]
    for i, j in ((K - 1, 0), (8, 7)):
        inv = jsim3.inverse(jnp.float32(1.0), jnp.asarray(true_R[j]), jnp.asarray(old_t[j]))
        sr, Rr, tr = jsim3.compose(jnp.float32(s_tear), jnp.asarray(true_R[i]),
                                   jnp.asarray(true_t[i]), *inv)
        edges.append((i, j))
        meas.append((float(sr), np.asarray(Rr), np.asarray(tr)))
        w.append(5.0)
    arrays = _sim3_arrays(K, E, R, t, s, np.arange(K) == 0, edges, meas, w)
    old, new = list(range(8)), list(range(8, K))
    tear0 = _sector_ratio(R, t, s, gt_c, new) / _sector_ratio(R, t, s, gt_c, old)
    assert tear0 > 1.25
    (jR, jt, js), (tR, tt, ts) = _solve_both(arrays, sim3=True)
    np.testing.assert_allclose(tR, jR, atol=TOL)
    np.testing.assert_allclose(tt, jt, atol=TOL)
    np.testing.assert_allclose(ts, js, atol=TOL)
    tear1 = _sector_ratio(tR, tt, ts, gt_c, new) / _sector_ratio(tR, tt, ts, gt_c, old)
    assert abs(np.log(tear1)) < np.log(1.08), (tear0, tear1)
    # the new sector's nodes took the tear's scale
    assert np.abs(ts[8:] - s_tear).max() < 0.08 * s_tear
    np.testing.assert_array_equal(tt[0], t[0])
