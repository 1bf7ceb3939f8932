"""plslam_torch localization-only tracking (mbVO) and the relocalization
gates, as units of the port's ``Tracker`` (CPU, 320x240, no lines).

- The VO branch of ``_finish``: with map matches starved but >= 20 motion
  inliers, localization-only mode keeps the frame and flags ``vo_mode``;
  mapping mode loses it; ``vo_mode`` clears once the local-map inliers
  reach twice the minimum; no keyframe is minted.
- ``_try_reacquire_map``'s consistency gate: a relocalized pose more than
  0.5 m or 30 degrees from the VO pose is rejected, a consistent one
  replaces it and rebinds the local map.
- The speed-scaled short-lost gate of ``_try_relocalize``, off in
  localization-only mode.
- ``process`` retries relocalization on every second frame in VO mode, and
  a frame retired with healthy map matches ends VO mode.

The relocalization pose itself is replaced by a stub in these units;
tests/test_torch_relocalization.py holds it against the JAX package.
"""

import dataclasses
import math

import numpy as np
import pytest

from plslam_torch import convert
from plslam_torch.models import relocalization as treloc
from plslam_torch.models import tracking as ttracking
from test_torch_relocalization import blackout_frames, jax_cfg, port_tracker
from torch_parity import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    return blackout_frames(fast=False)[0][:4]


@pytest.fixture()
def one_step(frames):
    """A port tracker initialized on frame 0 (local_mapper=None), and the
    fused step of frame 1 dispatched, not retired."""
    cfg = convert.config_from_dict(dataclasses.asdict(jax_cfg()))
    tr = port_tracker(cfg)
    tr.local_mapper = None
    tr.process(*frames[0], 0.0)
    tr.process(*frames[1], 1 / 30.0)
    assert tr.state == ttracking.OK and len(tr._queue) == 1
    return tr, tr._queue.pop(0)


def _with_stats(pending, n_motion_inliers, n_local_inliers):
    st = pending["out"].stats.clone()
    st[1], st[2] = n_motion_inliers, n_local_inliers
    return dict(pending, out=pending["out"]._replace(stats=st))


def test_finish_vo_branch(one_step):
    tr, pending = one_step
    need = tr.cfg.tracking.min_inliers_local_map
    n_kf, rows = tr.map.n_kf, len(tr.trajectory)
    starved = _with_stats(pending, 25, need - 1)  # map starved, VO healthy
    assert tr._finish(starved) is False  # mapping mode: the frame is lost
    tr.only_tracking = True
    assert tr._finish(_with_stats(pending, 19, need - 1)) is False  # VO too weak
    assert not tr.vo_mode
    assert tr._finish(starved) is True and tr.vo_mode
    assert len(tr.trajectory) == rows + 1 and tr.map.n_kf == n_kf
    assert tr._finish(_with_stats(pending, 25, need)) is True and tr.vo_mode  # not yet
    assert tr._finish(_with_stats(pending, 25, 2 * need)) is True and not tr.vo_mode
    assert tr.map.n_kf == n_kf  # localization mode mints no keyframe
    assert tr._need_new_keyframe(0, 500, 20) is False
    tr.only_tracking = False
    assert tr._need_new_keyframe(0, 500, 20) is True


def _yaw(deg):
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def test_reacquire_consistency_gate(one_step, monkeypatch):
    tr, _ = one_step
    tr.vo_mode = True
    R_vo, t_vo = tr._R.numpy().copy(), tr._t.numpy().copy()
    ids = tr.last_pt_ids.copy()
    answer = []
    monkeypatch.setattr(treloc, "try_relocalize", lambda tracker, fd: answer[-1])

    def offer(R, t):
        answer.append(None if R is None else (R.astype(np.float32), t.astype(np.float32), ids))
        return tr._try_reacquire_map()

    assert offer(None, None) is False
    # centre 0.6 m away (t = -R c): rejected
    assert offer(R_vo, t_vo - R_vo @ np.array([0.6, 0, 0], np.float32)) is False
    assert offer(_yaw(35.0) @ R_vo, t_vo) is False  # 35 degrees off: rejected
    assert tr.vo_mode and np.array_equal(tr._R.numpy(), R_vo)
    R_ok, t_ok = _yaw(10.0) @ R_vo, t_vo - R_vo @ np.array([0.3, 0, 0], np.float32)
    assert offer(R_ok, t_ok) is True
    assert not tr.vo_mode and tr._has_vel is False
    np.testing.assert_array_equal(tr._R.numpy(), R_ok.astype(np.float32))
    np.testing.assert_array_equal(tr.last_pose[1], t_ok.astype(np.float32))
    assert (tr._prev_slot_pt.numpy() >= 0).sum() > 0  # the local map rebound


def test_short_lost_gate_scales_with_speed(one_step, monkeypatch):
    tr, _ = one_step
    R, t = tr.last_pose
    far = (R, (t - R @ np.array([0.5, 0, 0], np.float32)).astype(np.float32))
    monkeypatch.setattr(treloc, "try_relocalize", lambda tracker, fd: (*far, tr.last_pt_ids))
    tr.state, tr.n_lost_frames = ttracking.LOST, 2
    tr._speed_est = 0.02  # budget 0.06 + 3 * 0.02 * 3 = 0.24 m < 0.5 m
    assert tr._try_relocalize(1.0) is False and tr.state == ttracking.LOST
    tr._speed_est = 0.06  # budget 0.6 m
    assert tr._try_relocalize(1.0) is True and tr.state == ttracking.OK
    tr.state, tr._speed_est, tr.last_pose = ttracking.LOST, 0.02, (R, t)
    tr.only_tracking = True  # a frozen map has no drift islands: no gate
    assert tr._try_relocalize(1.0) is True


def test_process_retries_every_second_frame_in_vo_mode(frames, monkeypatch):
    cfg = convert.config_from_dict(dataclasses.asdict(jax_cfg()))
    tr = port_tracker(cfg)
    tr.local_mapper = None
    tr.process(*frames[0], 0.0)
    calls = []
    monkeypatch.setattr(treloc, "try_relocalize", lambda tracker, fd: calls.append(
        tracker.frame_id))
    tr.only_tracking = tr.vo_mode = True
    for i in (1, 2, 3):
        tr.process(*frames[i], i / 30.0)
    assert calls == [2]  # frame ids 1..3: the even one
    assert not tr.vo_mode  # frame 1 retired with healthy map matches
