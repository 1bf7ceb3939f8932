"""plslam_torch.models.pointcloud against the JAX package's dense-cloud
mapper (CPU), on tests/test_pointcloud.py's cases:

- unprojection, accumulation and voxel dedup of a flat depth map at the
  identity pose: the same voxel set with the same kept samples;
- the loop-triggered rebuild follows corrected poses (the same voxels as
  JAX's after the correction; invalidated keyframes drop out);
- the amortized rebuild (``mark_dirty`` snapshots the poses, ``step``
  re-accumulates a bounded number of keyframes, ``drain`` the rest);
- the System polls ``big_change_idx`` and schedules ``mark_dirty``;

and on a rendered keyframe at a rotated pose, where the two packages'
float32 3x3 products may round a sample across a voxel boundary: voxel
keys agree on >= 99.9% in a world frame in general position (the saved
PCD files are byte-equal at the identity pose).
"""

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models.pointcloud import PointCloudMapper as JPointCloudMapper
from plslam_tpu.models.pointcloud import unproject_keyframe as junproject_keyframe
from plslam_torch.config import SlamConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.models.pointcloud import PointCloudMapper, unproject_keyframe
from plslam_torch.models.system import System
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory
from torch_parity import KW
from torch_parity import few_torch_threads  # noqa: F401

CAM = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)
KEY_AGREEMENT = 0.999


class FakeMap:
    def __init__(self, n):
        self.kf_R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
        self.kf_t = np.zeros((n, 3), np.float32)
        self.kf_valid = np.ones(n, bool)


def _flat_depth(val=2.0):
    return (np.full((480, 640), 100.0, np.float32), np.full((480, 640), val, np.float32))


def _pair():
    return (PointCloudMapper(SlamConfig(camera=Camera(**CAM)), device="cpu"),
            JPointCloudMapper(JSlamConfig(camera=JCamera(**CAM))))


def _assert_same_voxels(pcm, jpcm):
    assert pcm.voxels.keys() == jpcm.voxels.keys()
    for k, (p, i) in pcm.voxels.items():
        jp, ji = jpcm.voxels[k]
        np.testing.assert_array_equal(p, np.asarray(jp))
        assert i == ji


def test_unproject_accumulate_and_dedup(tmp_path):
    pcm, jpcm = _pair()
    gray, depth = _flat_depth()
    for c in (pcm, jpcm):
        c.insert_keyframe(0, gray, depth, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    _assert_same_voxels(pcm, jpcm)
    pts, _ = pcm.cloud()
    assert len(pts) > 1000 and np.allclose(pts[:, 2], 2.0, atol=0.02)
    n1 = len(pts)
    # the same keyframe again: the voxel dedup keeps the cloud's size
    pcm._accumulate(*pcm.kf_inputs[0], np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert len(pcm.cloud()[0]) == n1
    pcm.save_pcd(str(tmp_path / "port.pcd"))
    jpcm.save_pcd(str(tmp_path / "jax.pcd"))
    assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "jax.pcd").read_bytes()


def test_rebuild_follows_corrected_poses():
    pcm, jpcm = _pair()
    gray, depth = _flat_depth()
    m = FakeMap(1)
    for c in (pcm, jpcm):
        c.insert_keyframe(0, gray, depth, m.kf_R[0], m.kf_t[0])
    zb = np.median(pcm.cloud()[0][:, 2])
    m.kf_t[0, 2] = 0.3  # the correction pulls the camera back 30 cm
    for c in (pcm, jpcm):
        c.rebuild(m)
    _assert_same_voxels(pcm, jpcm)
    za = np.median(pcm.cloud()[0][:, 2])
    assert abs((za - zb) - (-0.3)) < 0.02, (zb, za)
    m.kf_valid[0] = False  # invalidated keyframes drop out of the rebuild
    pcm.rebuild(m)
    assert len(pcm.cloud()[0]) == 0


def test_amortized_rebuild_steps():
    pcm, jpcm = _pair()
    gray, depth = _flat_depth()
    m = FakeMap(3)
    for c in (pcm, jpcm):
        for k in range(3):
            c.insert_keyframe(k, gray, depth, m.kf_R[k], m.kf_t[k])
    m.kf_t[:, 2] = 0.3
    for c in (pcm, jpcm):
        c.mark_dirty(m)
    assert len(pcm.cloud()[0]) == 0  # cleared, rebuild pending
    for c in (pcm, jpcm):
        c.step(budget=1)
    assert pcm._rebuild_queue == jpcm._rebuild_queue == [0, 1]  # popped from the end
    _assert_same_voxels(pcm, jpcm)
    m.kf_t[:, 2] = 99.0  # edits after mark_dirty do not reach the snapshot
    for c in (pcm, jpcm):
        c.drain()
    assert not pcm._rebuild_queue
    _assert_same_voxels(pcm, jpcm)
    assert abs(np.median(pcm.cloud()[0][:, 2]) - 1.7) < 0.02


def test_system_polls_big_change(monkeypatch):
    """System.track_rgbd polls map.big_change_idx (System::MapChanged) and
    SCHEDULES a rebuild under the map lock (mark_dirty), with one step a
    frame."""
    cfg = SlamConfig(camera=Camera(**KW), use_lines=False)
    slam = System(cfg, enable_loop_closing=False, enable_dense_cloud=True, device="cpu")
    calls, steps = [], []
    monkeypatch.setattr(slam.cloud, "mark_dirty", lambda m: calls.append(m is slam.map))
    orig_step = slam.cloud.step
    monkeypatch.setattr(slam.cloud, "step", lambda: steps.append(1) or orig_step())
    scene = RoomScene(0)
    poses = smooth_trajectory(20)[:4]
    for i, (R, t) in enumerate(poses):
        g, d = scene.render(cfg.camera, R, t)
        slam.track_rgbd(g, d, i / 30.0)
    assert not calls and len(steps) == 4
    assert list(slam.cloud.kf_inputs) == [0]  # the initializing keyframe
    slam.map.big_change_idx += 1  # what a loop correction publishes
    g, d = scene.render(cfg.camera, *poses[-1])
    slam.track_rgbd(g, d, len(poses) / 30.0)
    assert calls == [True]
    slam.shutdown()


def _render(j):
    R, t = smooth_trajectory(60)[j]
    g, d = RoomScene(0).render(Camera(**CAM), R, t)
    return g.astype(np.float32), d.astype(np.float32), R.astype(np.float32), t.astype(np.float32)


# a world frame in general position: rotated about an oblique axis, shifted
W_ROTVEC, W_T = np.array([0.1, -0.2, 0.15]), np.array([0.123, 0.0456, -0.0789], np.float32)


def test_unproject_rotated_pose_matches_jax():
    """A rendered keyframe of the room, rotated by ~0.25 rad from frame 0.
    The two packages' float32 3x3 products differ in the last bit on some
    samples (XLA's CPU dot contracts only some lanes into fused multiply-
    adds). In a world frame in general position — a map's world is its
    first camera's frame — that moves a sample to another voxel rarely:
    voxel keys agree on >= 99.9%. In the room's own frame the walls lie on
    voxel boundaries (x = 2.0 m, z = 3.5 m) and ~3% of the samples flip:
    each flipped sample lies within 1e-4 voxel of a boundary."""
    gray, depth, R, t = _render(45)
    assert np.abs(R - np.eye(3)).max() > 0.2
    Rw = Rotation.from_rotvec(W_ROTVEC).as_matrix().astype(np.float32)
    Rg = (R @ Rw.T).astype(np.float32)
    tg = (t - Rg @ W_T).astype(np.float32)
    pcm, jpcm = _pair()
    for c in (pcm, jpcm):
        c.insert_keyframe(0, gray, depth, Rg, tg)
    keys, jkeys = set(pcm.voxels), set(jpcm.voxels)
    assert len(keys) > 30000
    agree = len(keys & jkeys) / len(keys | jkeys)
    assert agree >= KEY_AGREEMENT, agree
    # the unprojection in the room's frame, sample for sample
    s = pcm.cfg.cloud.pixel_stride
    g, d = (np.ascontiguousarray(a[::s, ::s]) for a in (gray, depth))
    pw, inten, ok = (a.numpy() for a in unproject_keyframe(
        pcm.cfg, *(torch.from_numpy(a) for a in (g, d, R, t))))
    jpw, jinten, jok = (np.asarray(a) for a in junproject_keyframe(jpcm.cfg, g, d, R, t))
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(inten, jinten)
    np.testing.assert_allclose(pw, jpw, rtol=0, atol=5e-7)
    v, jv = pw[ok] / pcm.cfg.cloud.voxel_size, jpw[ok] / pcm.cfg.cloud.voxel_size
    flip = np.floor(v) != np.floor(jv)
    assert flip.any()
    assert (np.abs(v - np.round(v))[flip] < 1e-4).all()
