"""plslam_torch pose-only LM against the JAX package's optim/pose.py.

Same observations (points with stereo and mono rows, lines, 15% gross
outliers, invalid padding rows), same start pose: R and t agree to 1e-4 and
the inlier masks are identical. The two run the same float32 protocol
(4 rounds x 10 LM iterations, Huber in rounds 1-2, chi² reclassification);
only the summation order of the normal equations and the 6x6 solve differ.
Also holds the SE(3) primitives and the line projection residuals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.geometry import lines as jlines
from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.optim import pose as jpose
from plslam_torch.geometry import lines as tlines
from plslam_torch.geometry import se3 as tse3
from plslam_torch.geometry.projection import Camera
from plslam_torch.optim import pose as tpose

KW = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)


def _problem(seed, n=400, nl=40):
    rng = np.random.default_rng(seed)
    cam = Camera(**KW)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
    t = rng.normal(0, 0.2, 3).astype(np.float32)
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(1.0, 5.0, n)], -1)
    pw = ((pc - t) @ R).astype(np.float32)  # x_w = R^T (x_c - t)
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    uv = np.stack([u, v], -1) + rng.normal(0, 0.7, (n, 2))
    out = rng.random(n) < 0.15
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    ur = np.where(rng.random(n) < 0.7, uv[:, 0] - cam.bf / pc[:, 2], -1.0)
    octave = rng.integers(0, 8, n)
    valid = rng.random(n) < 0.95
    # lines: endpoints in the camera frame, observed with noise
    s = np.stack([rng.uniform(-2, 2, nl), rng.uniform(-1.5, 1.5, nl), rng.uniform(1, 5, nl)], -1)
    e = s + rng.normal(0, 0.8, (nl, 3))
    e[:, 2] = np.abs(e[:, 2]) + 0.5
    sw, ew = (s - t) @ R, (e - t) @ R

    def proj(p):
        return np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                         cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)

    luv = np.stack([proj(s), proj(e)], 1) + rng.normal(0, 0.5, (nl, 2, 2))
    lout = rng.random(nl) < 0.1
    luv[lout] += 30.0
    n_w = np.cross(sw, ew)
    v_w = ew - sw
    obs = dict(
        p3d=pw, uv=uv, u_right=ur, inv_sigma2=(1 / 1.44) ** octave, valid=valid,
        line_nw=n_w, line_vw=v_w, line_uv=luv, line_inv_sigma2=np.ones(nl),
        line_valid=rng.random(nl) < 0.9)
    obs = {k: (v.astype(np.float32) if v.dtype != bool else v) for k, v in obs.items()}
    # start pose: perturbed truth
    xi = rng.normal(0, 0.02, 6).astype(np.float32)
    R0, t0 = (np.asarray(a) for a in jse3.left_update(jnp.asarray(xi), jnp.asarray(R),
                                                       jnp.asarray(t)))
    return obs, R0, t0, R, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose_parity(seed):
    obs, R0, t0, R, t = _problem(seed)
    jres = jpose.optimize_pose(JCamera(**KW), jnp.asarray(R0), jnp.asarray(t0),
                               jpose.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}))
    tres = tpose.optimize_pose(Camera(**KW), torch.from_numpy(R0), torch.from_numpy(t0),
                               tpose.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()}))
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-4)
    np.testing.assert_array_equal(tres.inlier_pts.numpy(), np.asarray(jres.inlier_pts))
    np.testing.assert_array_equal(tres.inlier_lines.numpy(), np.asarray(jres.inlier_lines))
    assert int(tres.n_inliers) == int(jres.n_inliers)
    # and it converged to the truth, outliers rejected
    np.testing.assert_allclose(tres.t.numpy(), t, atol=5e-3)
    assert int(tres.n_inliers) > 250


def test_se3_primitives():
    rng = np.random.default_rng(3)
    for _ in range(5):
        xi = rng.normal(0, 0.5, 6).astype(np.float32)
        jR, jt = jse3.se3_exp(jnp.asarray(xi))
        tR, tt = tse3.se3_exp(torch.from_numpy(xi))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
        np.testing.assert_allclose(tse3.so3_exp(torch.from_numpy(xi[:3])).numpy(),
                                   np.asarray(jse3.so3_exp(jnp.asarray(xi[:3]))), atol=1e-6)
        Rn = tR.numpy() + rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
        np.testing.assert_allclose(tse3.orthonormalize(torch.from_numpy(Rn)).numpy(),
                                   np.asarray(jse3.orthonormalize(jnp.asarray(Rn))), atol=1e-6)
    xi0 = torch.zeros(6)
    R0, t0 = tse3.se3_exp(xi0)
    np.testing.assert_allclose(R0.numpy(), np.eye(3), atol=0)


def test_line_residual_geometry():
    rng = np.random.default_rng(4)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t = np.array([0.1, 0.0, -0.2], np.float32)
    n = rng.normal(0, 1, (20, 3)).astype(np.float32)
    v = rng.normal(0, 1, (20, 3)).astype(np.float32)
    jn, jv = jlines.transform_plucker(jnp.asarray(R), jnp.asarray(t), jnp.asarray(n), jnp.asarray(v))
    tn, tv = tlines.transform_plucker(torch.from_numpy(R), torch.from_numpy(t),
                                      torch.from_numpy(n), torch.from_numpy(v))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    uv = rng.uniform(0, 600, (20, 2)).astype(np.float32)
    l = np.asarray(jlines.project_plucker(jlines.line_intrinsics(525., 525., 319.5, 239.5), jn))
    np.testing.assert_allclose(
        tlines.point_line_distance(torch.from_numpy(l), torch.from_numpy(uv)).numpy(),
        np.asarray(jlines.point_line_distance(jnp.asarray(l), jnp.asarray(uv))), rtol=1e-5, atol=1e-3)
    p0 = rng.uniform(-50, 700, (30, 2)).astype(np.float32)
    p1 = rng.uniform(-50, 700, (30, 2)).astype(np.float32)
    for a, b in zip(jlines.liang_barsky(jnp.asarray(p0), jnp.asarray(p1), 0., 0., 639., 479.),
                    tlines.liang_barsky(torch.from_numpy(p0), torch.from_numpy(p1), 0., 0., 639., 479.)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
