"""plslam_torch.optim.ba_cg (matrix-free PCG global BA) against the JAX
package's and against the port's dense solver.

Inputs are the JAX tests' problems (``tests/test_local_ba.py::build_problem``,
numpy-seeded; ``tests/test_ba_cg.py``'s C = 96 arc rebuilt here in numpy).

- One ``_lm_iteration_cg`` equals JAX's to 1e-5 relative, both in float64
  (the port solves in float64 like its dense solver; JAX runs in float64
  through ``jax.enable_x64``).
- ``bundle_adjust_cg_stepped`` gives poses within 1e-4 m / 1e-4 rad of
  JAX's in float64, points within 1e-3 m, >= 99.5% equal inlier masks.
- Against the port's dense ``bundle_adjust`` on the same problem, at
  ``tests/test_ba_cg.py``'s bars: both within 1 cm of the ground truth,
  mean pose errors within 5 mm of each other, cost <= 1.05 x dense.
- Outliers are classified, the fixed camera is bitwise untouched, the
  stepped call aborts between chunks, and C = 96 converges.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.optim import ba_cg as jcg
from plslam_tpu.optim import local_ba as jba
from plslam_torch import convert
from plslam_torch.geometry import se3
from plslam_torch.optim import ba_cg as tcg
from plslam_torch.optim import local_ba as tba
from test_local_ba import CAM, build_problem
from test_torch_local_ba import _arrays, _compare, _jax64
from torch_parity import few_torch_threads  # noqa: F401

TCAM = convert.Camera(*CAM)


def _f64(arr):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in arr.items()}


def _pose_err(res, poses):
    R, t = res.cam_R.numpy(), res.cam_t.numpy()
    return np.array([np.linalg.norm(-R[i].T @ t[i] + Rg.T @ tg) for i, (Rg, tg) in enumerate(poses)])


@pytest.fixture(scope="module")
def problem():
    prob, poses, pts, _ = build_problem(np.random.default_rng(0), noise=0.2)
    return _arrays(prob), poses


@pytest.mark.parametrize("robust", [True, False])
def test_lm_iteration_cg_matches_jax(problem, robust):
    arr64 = _f64(problem[0])
    tp = convert.ba_problem_from_numpy(arr64, device="cpu")
    with jax.enable_x64(True):
        jp = _jax64(arr64)
        js = jba.ba_state_init(jp)[:-1] + (jnp.float64(1e-4),)
        jout = jax.jit(jcg._lm_iteration_cg, static_argnums=(0, 3, 4))(CAM, jp, js, robust, 48)
        jout = [np.asarray(x) for x in jout]
    tout = tcg._lm_iteration_cg(TCAM, tp, tba.ba_state_init(tp), robust, 48)
    for a, b in zip(jout[:4], tout[:4]):
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()
    for a, b in zip(jout[4:6], tout[4:6]):
        np.testing.assert_array_equal(a, b.numpy())
    assert abs(float(jout[6]) - float(tout[6])) <= 1e-5 * float(jout[6])


def test_cg_matches_jax_float64(problem):
    arr64 = _f64(problem[0])
    with jax.enable_x64(True):
        ref = jcg.bundle_adjust_cg_stepped(CAM, _jax64(arr64))
        ref = jba.BAResult(*(np.asarray(v) for v in ref))
    res = tcg.bundle_adjust_cg_stepped(TCAM, convert.ba_problem_from_numpy(problem[0], device="cpu"))
    assert res.cam_R.dtype == torch.float32
    _compare(res, ref, 8)


def test_cg_matches_dense_solution(problem):
    arr, poses = problem
    dense = tba.bundle_adjust(TCAM, convert.ba_problem_from_numpy(arr, device="cpu"))
    runs = tcg.bundle_adjust_cg_stepped.runs
    cg = tcg.bundle_adjust_cg_stepped(TCAM, convert.ba_problem_from_numpy(arr, device="cpu"))
    assert tcg.bundle_adjust_cg_stepped.runs == runs + 1
    err_d, err_c = _pose_err(dense, poses), _pose_err(cg, poses)
    assert err_c.max() < 0.01 and err_d.max() < 0.01
    assert abs(err_c.mean() - err_d.mean()) < 5e-3
    assert float(cg.cost) <= float(dense.cost) * 1.05


def test_cg_classifies_outliers_and_keeps_fixed_camera():
    rng = np.random.default_rng(2)
    prob, poses, _, _ = build_problem(rng, n_lines=2)
    arr = _arrays(prob)
    uv = arr["obs_uv"].copy()
    n_out = int(0.1 * len(uv))
    bad = rng.choice(len(uv), n_out, replace=False)
    uv[bad] += rng.uniform(30, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    arr["obs_uv"] = uv.astype(np.float32)
    res = tcg.bundle_adjust_cg_stepped(TCAM, convert.ba_problem_from_numpy(arr, device="cpu"))
    np.testing.assert_array_equal(res.cam_R[0].numpy(), arr["cam_R"][0])
    np.testing.assert_array_equal(res.cam_t[0].numpy(), arr["cam_t"][0])
    bad_valid = bad[arr["obs_valid"][bad]]
    assert (~res.obs_inlier.numpy()[bad_valid]).mean() > 0.95
    assert _pose_err(res, poses).max() < 0.01


def test_cg_stepped_aborts(problem):
    tp = convert.ba_problem_from_numpy(problem[0], device="cpu")
    polls = []
    full = tcg.bundle_adjust_cg_stepped(TCAM, tp, should_abort=lambda: polls.append(1) or False)
    assert len(polls) == 3
    polls.clear()
    early = tcg.bundle_adjust_cg_stepped(TCAM, tp, should_abort=lambda: polls.append(1) or True)
    assert len(polls) == 1
    assert float(early.cost) >= float(full.cost) - 1e-3


def test_cg_large_camera_count():
    """C = 96 on a short arc (every view keeps the cloud in frame), 400
    points: CG converges (tests/test_ba_cg.py::test_cg_large_camera_count)."""
    rng = np.random.default_rng(5)
    n_cams, n_pts = 96, 400
    poses = []
    for i in range(n_cams):
        ang = 0.8 * (i / n_cams - 0.5)
        Rwc = se3.so3_exp(torch.tensor([0.0, ang, 0.0])).numpy()
        c = np.array([1.5 * np.sin(ang), 0.01 * i, -0.5 * np.cos(ang)], np.float32)
        poses.append((Rwc.T, -Rwc.T @ c))
    pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (n_pts, 3)).astype(np.float32)
    oc, ouv, our, oval = [], [], [], []
    for ci, (R, t) in enumerate(poses):
        pc = pts @ R.T + t
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
        ok = (pc[:, 2] > 0.3) & (uv[:, 0] > 10) & (uv[:, 0] < 630) & (uv[:, 1] > 10) \
            & (uv[:, 1] < 470)
        uv = uv + rng.normal(0, 0.2, uv.shape)
        oc.append(np.full(n_pts, ci))
        ouv.append(uv)
        our.append(uv[:, 0] - CAM.bf / pc[:, 2] + rng.normal(0, 0.2, n_pts))
        oval.append(ok)
    cam_R = np.stack([R for R, _ in poses]).astype(np.float32)
    cam_t = np.stack([t for _, t in poses]).astype(np.float32)
    xi = rng.standard_normal((n_cams, 6)).astype(np.float32) * 0.01
    Rn, tn = se3.left_update(torch.from_numpy(xi), torch.from_numpy(cam_R),
                             torch.from_numpy(cam_t))
    cam_R[1:], cam_t[1:] = Rn.numpy()[1:], tn.numpy()[1:]
    O = n_cams * n_pts
    prob = tba.make_problem(n_cams, n_pts, O, device="cpu")._replace(
        cam_R=torch.from_numpy(cam_R), cam_t=torch.from_numpy(cam_t),
        cam_fixed=torch.arange(n_cams) == 0, cam_valid=torch.ones(n_cams, dtype=torch.bool),
        pt_xyz=torch.from_numpy(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        pt_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=torch.from_numpy(np.concatenate(oc)),
        obs_pt=torch.arange(n_pts).repeat(n_cams),
        obs_uv=torch.from_numpy(np.concatenate(ouv).astype(np.float32)),
        obs_ur=torch.from_numpy(np.concatenate(our).astype(np.float32)),
        obs_valid=torch.from_numpy(np.concatenate(oval)))
    err0 = _pose_err(prob, poses)
    res = tcg.bundle_adjust_cg_stepped(TCAM, prob, iters1=5, iters2=10, cg_iters=64)
    err1 = _pose_err(res, poses)
    assert err1.mean() < 0.3 * err0.mean(), (err0.mean(), err1.mean())
    assert err1.max() < 0.02
