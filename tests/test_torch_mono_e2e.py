"""The port's copy of tests/test_mono.py (slow tier): the two-view
bootstrap and scale-ambiguous tracking at 640x480 on the CPU, with the JAX
test's bars (Tracking.cc:729-903)."""

import numpy as np
import pytest

from plslam_torch.config import SlamConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.map import SlamMap
from plslam_torch.models.tracking import NOT_INITIALIZED, OK, Tracker
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory
from test_mono import _sim_align

pytestmark = pytest.mark.slow  # system-level e2e tier


def _cfg():
    return SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))


def test_mono_bootstrap_and_tracking():
    cfg = _cfg()
    scene = RoomScene(0)
    n = 40
    poses = smooth_trajectory(2 * n)[:n]
    m = SlamMap(cfg, device="cpu")
    tr = Tracker(cfg, m, local_mapper=LocalMapper(cfg, m), sensor="mono")
    for i, (R, t) in enumerate(poses):
        g, _ = scene.render(cfg.camera, R, t)
        tr.process_mono(g, i / 30.0)
    tr.flush()
    assert tr.state == OK
    assert m.n_kf >= 2
    assert m.n_points() > 100
    # the trajectory is right up to a similarity
    ts = np.array([t for t, _, _ in tr.trajectory])
    est = np.array([-R.T @ t for _, R, t in tr.trajectory])
    idx = np.clip((ts * 30).round().astype(int), 0, n - 1)
    gt = np.array([-poses[i][0].T @ poses[i][1] for i in idx])
    assert len(est) >= n - 10  # the bootstrap takes a few frames
    assert _sim_align(est, gt) < 0.05  # 5 cm at room scale


def test_mono_rejects_without_parallax():
    cfg = _cfg()
    R0, t0 = smooth_trajectory(4)[0]
    m = SlamMap(cfg, device="cpu")
    tr = Tracker(cfg, m, sensor="mono")
    g, _ = RoomScene(0).render(cfg.camera, R0, t0)
    for i in range(3):  # identical frames: no baseline, must not initialize
        tr.process_mono(g, i / 30.0)
    assert tr.state == NOT_INITIALIZED
    assert m.n_kf == 0
