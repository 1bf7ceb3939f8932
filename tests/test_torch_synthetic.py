"""plslam_torch's synthetic room, BRIEF table and camera model against the
JAX package.

The room is what chip_smoke.py and the tracking tests render, so its poses
and images must match the JAX package's to 1e-6 (the trajectory's Rodrigues
is float32 numpy here, float32 JAX there). The BRIEF pattern is a
byte-identical copy. Undistortion matches the JAX function (and OpenCV, as
tests/test_geometry.py holds it).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import plslam_torch
import plslam_tpu
from plslam_tpu.geometry import projection as jproj
from plslam_tpu.utils import synthetic as jsyn
from plslam_torch.geometry import projection as tproj
from plslam_torch.utils import synthetic as tsyn

TUM1 = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)


@pytest.mark.parametrize("n", [20, 300])
def test_trajectory(n):
    for (jR, jt), (tR, tt) in zip(jsyn.smooth_trajectory(n), tsyn.smooth_trajectory(n)):
        np.testing.assert_allclose(tR, jR, atol=1e-6)
        np.testing.assert_allclose(tt, jt, atol=1e-6)


@pytest.mark.parametrize("k", [0, 77])
def test_room_render(k):
    cam_j = jproj.Camera(fx=131.25, fy=131.25, cx=79.5, cy=59.5, width=160, height=120)
    cam_t = tproj.Camera(*cam_j)
    jR, jt = jsyn.smooth_trajectory(300)[k]
    tR, tt = tsyn.smooth_trajectory(300)[k]
    jg, jd = jsyn.RoomScene(0).render(cam_j, jR, jt)
    tg, td = tsyn.RoomScene(0).render(cam_t, tR, tt)
    np.testing.assert_allclose(tg, jg, atol=1e-3)
    np.testing.assert_allclose(td, jd, atol=1e-6)


def test_orb_pattern_is_byte_identical():
    a = os.path.join(os.path.dirname(plslam_tpu.__file__), "ops", "orb_pattern.npy")
    b = os.path.join(os.path.dirname(plslam_torch.__file__), "ops", "orb_pattern.npy")
    assert filecmp.cmp(a, b, shallow=False)


def test_undistort_matches_jax_and_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    pts = rng.uniform(100, 500, (50, 2)).astype(np.float32)
    jcam, tcam = jproj.Camera(**TUM1), tproj.Camera(**TUM1)
    want = np.asarray(jproj.undistort_points(jcam, jnp.asarray(pts)))
    got = tproj.undistort_points(tcam, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    K = tcam.K
    dist = np.array([tcam.k1, tcam.k2, tcam.p1, tcam.p2, tcam.k3], np.float32)
    cv_out = cv2.undistortPoints(pts.reshape(-1, 1, 2), K, dist, P=K).reshape(-1, 2)
    got20 = tproj.undistort_points(tcam, torch.from_numpy(pts), iters=20).numpy()
    np.testing.assert_allclose(got20, cv_out, atol=0.1)
    assert tproj.undistorted_bounds(tcam) == pytest.approx(
        jproj.undistorted_bounds(jcam), abs=1e-3)


def test_project_backproject():
    cam = tproj.Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5)
    rng = np.random.default_rng(8)
    uv = torch.tensor(rng.uniform(50, 400, (20, 2)), dtype=torch.float32)
    d = torch.tensor(rng.uniform(0.5, 5.0, 20), dtype=torch.float32)
    np.testing.assert_allclose(tproj.project(cam, tproj.backproject(cam, uv, d)).numpy(),
                               uv.numpy(), atol=1e-3)
    jcam = jproj.Camera(*cam)
    np.testing.assert_allclose(
        tproj.backproject(cam, uv, d).numpy(),
        np.asarray(jproj.backproject(jcam, jnp.asarray(uv.numpy()), jnp.asarray(d.numpy()))),
        atol=1e-6)
