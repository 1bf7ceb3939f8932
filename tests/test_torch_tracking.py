"""plslam_torch tracking frontend against the JAX package's Tracker.

Runs at 320x240, the smallest size at which the JAX tracker's RGB-D
initialization finds its 300 keypoints with depth. Both packages get the
same rendered frames and run without local mapping (local_mapper=None).

1. Both trackers are seeded from the same JAX-initialized map (carried by
   ``plslam_torch.convert``): the port's local-map harvest equals the JAX
   one exactly, and one ``fused_track_step`` on the next frame agrees in
   pose (1e-3 m / 1e-3 rad), stats (within 2%) and slot bindings (98%),
   both from the true velocity prior and from a wrong one that forces the
   rescue stage. The small differences come from the pyramid resize and
   summation order (test_torch_image.py, test_torch_orb.py).
2. Eight frames through ``Tracker.process`` in both packages — long enough
   for a keyframe event (min_frames_between_kf=3): every frame tracks, the
   keyframe counts are equal and per-frame poses agree to 2 mm.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.config import tum1_config
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_torch import convert
from plslam_torch.bow.database import KeyFrameDatabase
from plslam_torch.bow.vocabulary import Vocabulary
from plslam_torch.models import tracking as ttracking
from plslam_torch.models.frame import FrameData
from plslam_torch.models.map import SlamMap
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

KW = dict(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=40.0, width=320, height=240)
N_FRAMES = 8


@pytest.fixture(scope="module")
def frames():
    scene = RoomScene(0)
    out = []
    for R, t in smooth_trajectory(300)[:N_FRAMES]:
        g, d = scene.render(convert.Camera(**KW), R, t)
        out.append((np.clip(g, 0, 255).astype(np.uint8),
                    np.clip(d * 5000.0, 0, 65535).astype(np.uint16)))
    return out


@pytest.fixture(scope="module")
def jcfg():
    return JSlamConfig(camera=JCamera(**KW))


def test_config_from_dict():
    for jc in (JSlamConfig(camera=JCamera(**KW)), tum1_config()):
        tc = convert.config_from_dict(dataclasses.asdict(jc))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tuple(tc.camera) == tuple(jc.camera)


def _map_arrays(jm):
    d = {k: getattr(jm, k) for k in convert._ARRAYS}
    d.update(pt_obs=jm.pt_obs, ln_obs=jm.ln_obs, kf_children=jm.kf_children,
             n_kf=jm.n_kf, _pt_next=jm._pt_next, _ln_next=jm._ln_next,
             loop_edges=jm.loop_edges, big_change_idx=jm.big_change_idx,
             kf_frames=jm.kf_frames,
             pt_desc_arena=np.asarray(jm.point_desc_arena()),
             ln_desc_arena=np.asarray(jm.line_desc_arena()))
    return d


def _rot_err(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.fixture(scope="module")
def shared(frames, jcfg):
    """A JAX tracker initialized on frame 0 and a port tracker seeded from
    its map, prior frame, pose and local map."""
    jm = JSlamMap(jcfg)
    jt = jtracking.Tracker(jcfg, jm)
    jt.process(*frames[0], 0.0)
    assert jt.state == jtracking.OK

    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    m = convert.map_from_numpy(_map_arrays(jm), cfg, device="cpu")
    assert m.n_kf == jm.n_kf and m.n_points() == jm.n_points() and m.n_lines() == jm.n_lines()
    tr = ttracking.Tracker(cfg, m)
    tr.state = ttracking.OK
    tr.frame_id, tr.last_kf_id = jt.frame_id, jt.last_kf_id
    tr.last_kf, tr.ref_kf = jt.last_kf, jt.ref_kf
    tr._prev_fd = FrameData(*(torch.tensor(np.asarray(getattr(jt._prev_fd, f)))
                              for f in FrameData._fields))
    tr._R = torch.tensor(np.asarray(jt._R))
    tr._t = torch.tensor(np.asarray(jt._t))
    tr._refresh_local_map(jt.last_pt_ids, jt.last_ln_ids)
    return jt, tr, cfg


def _both_steps(shared, jcfg, frame, vel=None):
    """One fused step of each package on ``frame``; ``vel`` = (R, t)
    replaces the velocity prior of both."""
    jt, tr, cfg = shared
    jargs, targs = list(jt.dispatch_args()), list(tr.dispatch_args())
    if vel is not None:
        R, t = (np.asarray(v, np.float32) for v in vel)
        jargs[7:10] = [jnp.asarray(R), jnp.asarray(t), jnp.asarray(True)]
        targs[7:10] = [torch.from_numpy(R), torch.from_numpy(t), True]
    g, d = frame
    jg, jd = jt._quantize_inputs(g, d)
    jo = jtracking.fused_track_step(jcfg, jnp.asarray(jg), jnp.asarray(jd), *jargs,
                                    stereo=False)
    tg, td = tr._quantize_inputs(g, d)
    to = ttracking.fused_track_step(cfg, torch.from_numpy(tg),
                                    torch.from_numpy(td.astype(np.int32)), *targs)
    return jo, to


def _assert_steps_agree(jo, to):
    assert _rot_err(np.asarray(jo.R), to.R.numpy()) < 1e-3
    assert np.abs(np.asarray(jo.t) - to.t.numpy()).max() < 1e-3
    np.testing.assert_allclose(to.stats.numpy(), np.asarray(jo.stats), rtol=0.02, atol=2)
    for name in ("feat_slot_pt", "lm_feat", "lm_inlier"):
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert (a == b).mean() >= 0.98, (name, (a == b).mean())
    bound = np.asarray(jo.feat_slot_pt) >= 0
    assert (np.asarray(jo.feat_slot_pt)[bound] == to.feat_slot_pt.numpy()[bound]).mean() >= 0.98


def test_fused_step_from_shared_map(frames, jcfg, shared):
    jt, tr, _ = shared
    # the local-map harvest and the slot tables carry across exactly
    np.testing.assert_array_equal(tr._lp_ids, jt._lp_ids)
    np.testing.assert_array_equal(tr._ll_ids, jt._ll_ids)
    for a, b in zip(jt._lm_args, tr._lm_args):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tr._prev_slot_pt.numpy(), np.asarray(jt._prev_slot_pt))
    np.testing.assert_array_equal(tr._prev_slot_ln.numpy(), np.asarray(jt._prev_slot_ln))

    jo, to = _both_steps(shared, jcfg, frames[1])
    assert np.asarray(jo.stats)[2] > 300  # a healthy local-map stage
    assert np.asarray(jo.stats)[5] == to.stats.numpy()[5] == 0  # no rescue
    _assert_steps_agree(jo, to)


def test_fused_step_rescue(frames, jcfg, shared):
    """A wrong velocity prior (0.4 m sideways, 20 degrees of yaw) starves the
    motion stage; both packages then take the rescue stage (windowless
    local-map match + pose LM from the last pose) and agree on it."""
    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    R_bad = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    jo, to = _both_steps(shared, jcfg, frames[1], vel=(R_bad, [0.4, 0.0, 0.0]))
    js, ts = np.asarray(jo.stats), to.stats.numpy()
    assert js[5] > 100 and ts[5] > 100  # the rescue fired and won in both
    assert js[1] == js[5] and ts[1] == ts[5]  # and carried the frame
    _assert_steps_agree(jo, to)
    # the rescue lands on the pose the good prior gives
    jg, _ = _both_steps(shared, jcfg, frames[1])
    assert np.abs(to.t.numpy() - np.asarray(jg.t)).max() < 2e-3


def test_sequence_through_process(frames, jcfg):
    jm = JSlamMap(jcfg)
    jt = jtracking.Tracker(jcfg, jm)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    m = SlamMap(cfg, device="cpu")
    tr = ttracking.Tracker(cfg, m)
    for i, (g, d) in enumerate(frames):
        jt.process(g, d, i / 30.0)
        tr.process(g, d, i / 30.0)
        assert tr.state == ttracking.OK, i
    jt.flush()
    tr.flush()
    assert len(tr.trajectory) == len(jt.trajectory) == N_FRAMES
    assert m.n_kf == jm.n_kf >= 2
    assert abs(m.n_points() - jm.n_points()) <= 0.02 * jm.n_points()
    for (ts, R, t), (jts, jR, jtt) in zip(tr.trajectory, jt.trajectory):
        assert ts == jts
        c, jc = -(R.T @ t), -(jR.T @ jtt)
        assert np.linalg.norm(c - jc) < 2e-3
        assert _rot_err(R, jR) < 2e-3


def test_to_host_roundtrip():
    xs = [torch.arange(6, dtype=torch.int32), torch.rand(3, 3),
          torch.tensor([True, False, True]), torch.arange(5, dtype=torch.int16),
          torch.arange(12, dtype=torch.uint8).reshape(3, 4)]
    for x, h in zip(xs, ttracking._to_host(xs)):
        np.testing.assert_array_equal(h, x.numpy())
        assert h.dtype == x.numpy().dtype


def test_unported_paths_raise():
    cfg = convert.config_from_dict(dataclasses.asdict(JSlamConfig(camera=JCamera(**KW))))
    m = SlamMap(cfg, device="cpu")
    with pytest.raises(ValueError):
        ttracking.Tracker(cfg, m, sensor="depth")
    assert ttracking.Tracker(cfg, m, sensor="mono").sensor == "mono"
    tr = ttracking.Tracker(cfg, m)
    assert tr._try_relocalize(0.0) is False  # no vocabulary / database
    # an RGB-D tracker takes no stereo pair and no monocular frame
    with pytest.raises(RuntimeError):
        tr.process_stereo(None, None, 0.0)
    with pytest.raises(RuntimeError):
        tr.process_mono(None, 0.0)
    # a vocabulary and a keyframe database are accepted (relocalization)
    voc = Vocabulary.load(device="cpu")
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    tr = ttracking.Tracker(cfg, m, voc=voc, kfdb=kfdb)
    assert tr.voc is voc and tr.kfdb is kfdb
    # and a loop closer (loop closing)
    lc = object()
    assert ttracking.Tracker(cfg, m, loop_closer=lc, voc=voc, kfdb=kfdb).loop_closer is lc
