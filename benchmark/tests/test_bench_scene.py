"""The benchmark's torch renderer and path against the package's numpy room."""

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.spec import Spec
from plslam_torch.geometry.projection import Camera
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

CAM = Camera(fx=535.4 / 4, fy=539.2 / 4, cx=320.1 / 4, cy=247.6 / 4, bf=40.0,
             width=160, height=120)


def test_textures_are_the_rooms():
    for seed in (0, 3, 2**31 + 5):
        np.testing.assert_array_equal(scene.room_textures(seed), np.stack(RoomScene(seed).tex))


def test_render_matches_the_numpy_room():
    rs, room = RoomScene(1), scene.Room(1, "cpu")
    R, t = scene.path_poses(np.arange(0, 600, 53), 600)
    g, d = room.render(CAM, torch.tensor(R, dtype=torch.float32),
                       torch.tensor(t, dtype=torch.float32))
    for i in range(len(R)):
        g0, d0 = rs.render(CAM, R[i].astype(np.float32), t[i].astype(np.float32))
        # float32 sums in another order: a few 1e-3 of a gray level, 1e-6 m
        np.testing.assert_allclose(g[i].numpy(), g0, atol=0.02)
        np.testing.assert_allclose(d[i].numpy(), d0, atol=1e-5)


def test_path_is_the_smooth_trajectory_made_periodic():
    period = 600
    R, t = scene.path_poses(np.arange(period + 1), period)
    ref = smooth_trajectory(period + 1)
    for i in range(0, period + 1, 37):
        np.testing.assert_allclose(R[i], ref[i][0], atol=1e-6)
        np.testing.assert_allclose(t[i], ref[i][1], atol=1e-6)
    np.testing.assert_allclose(R[period], R[0], atol=1e-12)  # wraps without a jump
    np.testing.assert_allclose(t[period], t[0], atol=1e-12)
    speed, rot = scene.path_speed(period, 30.0)
    assert 0.20 < speed < 0.25 and 3.5 < rot < 4.2


def test_the_traffic_path_turns_at_the_sequences_rate():
    """fr3/long_office_household's mean rotation, 10.2 degrees a second."""
    traffic = Spec().traffic("explore")
    speed, rot = scene.path_speed(traffic["period_frames"], traffic["fps"], **traffic["path"])
    assert 0.20 < speed < 0.25 and rot == pytest.approx(10.2, abs=0.05)


def test_wire_format_truncates_like_numpy():
    g = torch.tensor([[-3.0, 0.4, 17.9, 254.99, 300.0]])
    d = torch.tensor([[0.0, 1e-4, 0.8, 4.0, 20.0]])
    gw, dw = scene.to_wire(g, d, 5000.0)
    np.testing.assert_array_equal(gw.numpy(), np.clip(g.numpy(), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(dw.numpy(),
                                  np.clip(d.numpy() * 5000.0, 0, 65535).astype(np.uint16))
