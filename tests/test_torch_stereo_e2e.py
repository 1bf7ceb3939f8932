"""The port's copy of tests/test_stereo.py (slow tier): stereo depth and
TrackStereo end to end at 640x480 on the CPU, with the JAX test's bars
(Frame.cc:888-1062, Tracking.cc:170-208)."""

import numpy as np
import pytest
import torch

from plslam_torch.config import SlamConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.models import frame as mframe
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.map import SlamMap
from plslam_torch.models.tracking import OK, Tracker
from plslam_torch.utils import tum_io
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

pytestmark = pytest.mark.slow  # system-level e2e tier


def _cfg():
    return SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))


def stereo_pair(scene, cam, R, t):
    """uint8 left and right images (the right camera bf / fx to the right)
    and the left depth."""
    b = cam.bf / cam.fx
    gl, dl = scene.render(cam, R, t)
    gr, _ = scene.render(cam, R, t - np.array([b, 0, 0], np.float32))
    return (np.clip(gl, 0, 255).astype(np.uint8), np.clip(gr, 0, 255).astype(np.uint8), dl)


def test_stereo_depth_accuracy():
    cfg = _cfg()
    R, t = smooth_trajectory(4)[0]
    gl, gr, dl = stereo_pair(RoomScene(0), cfg.camera, R, t)
    fd = mframe.build_frame_stereo(torch.from_numpy(gl), torch.from_numpy(gr), cfg)
    ok = (fd.kp_valid & (fd.kp_depth > 0)).numpy()
    assert ok.sum() > 200  # most keypoints get stereo depth
    xy = np.round(fd.kp_xy.numpy()[ok]).astype(int)
    gt = dl[np.clip(xy[:, 1], 0, 479), np.clip(xy[:, 0], 0, 639)]
    rel = np.abs(fd.kp_depth.numpy()[ok] - gt) / np.maximum(gt, 1e-6)
    assert np.median(rel) < 0.03  # subpixel SAD disparity


def test_stereo_tracking_e2e():
    cfg = _cfg()
    scene = RoomScene(0)
    n = 25
    poses = smooth_trajectory(2 * n)[:n]
    m = SlamMap(cfg, device="cpu")
    tr = Tracker(cfg, m, local_mapper=LocalMapper(cfg, m), sensor="stereo")
    for i, (R, t) in enumerate(poses):
        gl, gr, _ = stereo_pair(scene, cfg.camera, R, t)
        tr.process_stereo(gl, gr, i / 30.0)
    tr.flush()
    assert tr.state == OK
    assert m.n_kf >= 1
    ts = np.array([s for s, _, _ in tr.trajectory])
    est = np.array([-R.T @ t for _, R, t in tr.trajectory])
    gt = np.array([-R.T @ t for R, t in poses])
    assert len(est) >= n - 2
    assert tum_io.ate_rmse(ts, est, np.arange(n) / 30.0, gt) < 0.03  # 3 cm
