"""plslam_torch relocalization and localization-only tracking against the
JAX package's.

The blackout scenario of tests/test_relocalization.py at 320x240 with
``use_lines=False``: 15 tracked frames of ``smooth_trajectory(60)``, 4
blackout frames (uniform gray, no depth), then a return to views seen
before. The JAX package runs it first (module fixture) and relocalizes;
its map and keyframe database are carried to the port by
``plslam_torch.convert``.

- ``reloc_candidate_step`` on the same return frame against the first
  candidate keyframe, with the RANSAC draws the JAX package makes from its
  key injected: pose within 1e-3 m / 1e-3 rad, inliers within 2, matched
  indices equal on >= 98% of the features; and the candidate lists equal.
- ``try_relocalize`` with each package's own draws picks the same
  candidate and lands on the same pose.
- The port through ``Tracker.process`` (its own map) relocalizes on the
  same return frame as the JAX package, within 5 cm of ground truth.
- ``reset`` clears the database and the relocalization state.

The fast-camera scenario is tests/test_torch_relocalization_fast.py, the
localization-only units tests/test_torch_vo_mode.py.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.bow.database import KeyFrameDatabase as JKeyFrameDatabase
from plslam_tpu.bow.vocabulary import Vocabulary as JVocabulary
from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import relocalization as jreloc
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_tpu.ops import matching as jmatching
from plslam_torch import convert
from plslam_torch.bow.database import KeyFrameDatabase
from plslam_torch.bow.vocabulary import Vocabulary, sparse_bow
from plslam_torch.models import relocalization as treloc
from plslam_torch.models import tracking as ttracking
from plslam_torch.models.frame import FrameData
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.map import SlamMap
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory
from test_torch_bow import VOCABS
from torch_parity import KW, map_arrays
from torch_parity import few_torch_threads  # noqa: F401

BLACK = (np.full((240, 320), 120, np.uint8), np.zeros((240, 320), np.uint16))


def blackout_frames(fast: bool):
    """(frames, returning, poses): 15 tracked frames, 4 blackout frames,
    then 8 frames back over views seen before; ``returning[j]`` is the pose
    index of return frame j. ``fast``: twice the speed
    (``smooth_trajectory(30)``), stepping back two poses a frame."""
    scene = RoomScene(0)
    poses = smooth_trajectory(30)[:15] if fast else smooth_trajectory(60)[:30]
    cam = convert.Camera(**KW)

    def render(R, t):
        g, d = scene.render(cam, R, t)
        return (np.clip(g, 0, 255).astype(np.uint8),
                np.clip(d * 5000.0, 0, 65535).astype(np.uint16))

    returning = [max(10 - j * (2 if fast else 1), 2) for j in range(8)]
    frames = [render(*poses[i]) for i in range(15)] + [BLACK] * 4
    return frames + [render(*poses[k]) for k in returning], returning, poses


def center_error(pose, poses, k):
    """Camera-centre error of ``pose`` against ground-truth pose k, in the
    map's gauge (world = the first camera)."""
    R0g, t0g = poses[0]
    Rg, tg = poses[k]
    Rrel = Rg @ R0g.T
    trel = tg - Rrel @ t0g
    Re, te = pose
    return float(np.linalg.norm(-Re.T @ te + Rrel.T @ trel))


def run_blackout(tracker, frames, returning, poses):
    """Feeds the scenario; returns (state after the blackout, index of the
    return frame that relocalized or None, its centre error)."""
    for i, (g, d) in enumerate(frames[:19]):
        tracker.process(g, d, i / 30.0)
    lost = tracker.state
    for j, (g, d) in enumerate(frames[19:]):
        out = tracker.process(g, d, (19 + j) / 30.0)
        if tracker.state == ttracking.OK:
            return lost, j, center_error(out, poses, returning[j])
    return lost, None, None


def jax_cfg():
    return JSlamConfig(camera=JCamera(**KW), use_lines=False)


def jax_tracker(jcfg):
    voc = JVocabulary.load(VOCABS["synth"])
    jm = JSlamMap(jcfg)
    kfdb = JKeyFrameDatabase(voc, max_kf=jcfg.capacity.max_keyframes)
    return jtracking.Tracker(jcfg, jm, local_mapper=JLocalMapper(jcfg, jm), voc=voc, kfdb=kfdb)


def port_tracker(cfg, device="cpu"):
    voc = Vocabulary.load(device=device)
    m = SlamMap(cfg, device=device)
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    return ttracking.Tracker(cfg, m, local_mapper=LocalMapper(cfg, m, kfdb=kfdb), voc=voc,
                             kfdb=kfdb)


@pytest.fixture(scope="module")
def scenario():
    return blackout_frames(fast=False)


@pytest.fixture(scope="module")
def jax_run(scenario):
    """The JAX package through the scenario; its tracker relocalized."""
    frames, returning, poses = scenario
    jcfg = jax_cfg()
    jt = jax_tracker(jcfg)
    lost, at, err = run_blackout(jt, frames, returning, poses)
    assert lost == jtracking.LOST
    assert at is not None and at <= 5 and err < 0.05, (at, err)
    return jcfg, jt, at, err


@pytest.fixture(scope="module")
def carried(jax_run):
    """The JAX map and database in the port, and the relocalized frame."""
    jcfg, jt, _, _ = jax_run
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    m = convert.map_from_numpy(map_arrays(jt.map), cfg, device="cpu")
    jdb = jt.kfdb
    voc = convert.vocabulary_from_numpy([np.asarray(d) for d in jt.voc.node_desc],
                                        np.asarray(jt.voc.idf), device="cpu")
    kfdb = convert.kfdb_from_numpy(voc, [jdb.get_bow(k) for k in range(jdb.max_kf)],
                                   jdb.max_kf)
    fd = FrameData(*(torch.tensor(np.asarray(getattr(jt._prev_fd, f)))
                     for f in FrameData._fields))
    tr = ttracking.Tracker(cfg, m, voc=voc, kfdb=kfdb)
    tr.frame_id = jt.frame_id
    return cfg, tr, fd


def _rot_err(Ra, Rb):
    return math.acos(max(-1.0, min(1.0, (np.trace(Ra.T @ Rb) - 1.0) / 2.0)))


def test_candidate_step_with_jax_draws(jax_run, carried):
    jcfg, jt, _, _ = jax_run
    cfg, tr, fd = carried
    jm, jfd = jt.map, jt._prev_fd
    _, jbow = jt.voc.transform(jfd.kp_desc, jfd.kp_valid)
    jcands = jt.kfdb.detect_reloc_candidates(np.asarray(jbow), jm)
    _, bow = tr.voc.transform(fd.kp_desc, fd.kp_valid)
    assert tr.kfdb.detect_reloc_candidates(sparse_bow(bow), tr.map) == jcands
    assert jcands
    kf = jcands[0]
    # the JAX package's inputs and draws for candidate 0 (relocalization.py)
    pids = jm.kf_pt_idx[kf]
    has = (pids >= 0) & jm.pt_valid[np.clip(pids, 0, None)] & jm.kf_frames[kf].kp_valid
    ptw = np.zeros((len(pids), 3), np.float32)
    ptw[has] = jm.pt_pos[pids[has]]
    dkf = jm.device_frame(kf)
    key = jax.random.fold_in(jax.random.PRNGKey(jt.frame_id), 0)
    jR, jtt, jidx, jinl, jn = jreloc.reloc_candidate_step(
        jcfg, jfd, dkf.kp_desc, dkf.kp_angle, jnp.asarray(has), jnp.asarray(ptw), key)
    jm_ = jmatching.match_descriptors(
        jfd.kp_desc, dkf.kp_desc, jfd.kp_valid[:, None] & jnp.asarray(has)[None, :], 100,
        nn_ratio=jcfg.matcher.nn_ratio_reloc, angle_q=jfd.kp_angle, angle_t=dkf.kp_angle,
        dedupe=True)
    ok = np.asarray(jm_.ok)
    pool = max(int((ok & (np.asarray(jfd.kp_depth) > 0)).sum()), 3)
    horn = np.asarray(jax.random.randint(key, (256, 3), 0, pool))
    p = jnp.where(jnp.asarray(ok), 1.0, 0.0)
    p = p / (p.sum() + 1e-9)
    sets = np.asarray(jax.vmap(lambda k: jax.random.choice(k, len(ok), (6,), replace=False, p=p))(
        jax.random.split(jax.random.fold_in(key, 1), 256)))

    t_has, t_ptw = treloc.candidate_inputs(tr.map, kf)
    np.testing.assert_array_equal(t_has.numpy(), has)
    np.testing.assert_array_equal(t_ptw.numpy(), ptw)
    tkf = tr.map.device_frame(kf)
    R, t, idx, inl, n = treloc.reloc_candidate_step(
        cfg, fd, tkf.kp_desc, tkf.kp_angle, t_has, t_ptw,
        horn_samples=torch.from_numpy(horn.copy()), epnp_samples=torch.from_numpy(sets.copy()))
    assert int(jn) >= treloc.RELOC_ACCEPT_INLIERS
    assert abs(int(n) - int(jn)) <= 2
    assert np.abs(t.numpy() - np.asarray(jtt)).max() < 1e-3
    assert _rot_err(R.numpy(), np.asarray(jR)) < 1e-3
    assert (idx.numpy() == np.asarray(jidx)).mean() >= 0.98
    assert (inl.numpy() == np.asarray(jinl)).mean() >= 0.98


def _count_calls(monkeypatch, module):
    calls = []
    orig = module.reloc_candidate_step

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(module, "reloc_candidate_step", counted)
    return calls


def test_try_relocalize_picks_the_same_candidate(jax_run, carried, monkeypatch):
    _, jt, _, _ = jax_run
    _, tr, fd = carried
    jcalls = _count_calls(monkeypatch, jreloc)
    tcalls = _count_calls(monkeypatch, treloc)
    jout = jreloc.try_relocalize(jt, jt._prev_fd)
    tout = treloc.try_relocalize(tr, fd)
    assert jout is not None and tout is not None
    assert len(tcalls) == len(jcalls) >= 1
    (jR, jtt, jids), (R, t, ids) = jout, tout
    assert np.abs(t - np.asarray(jtt)).max() < 1e-3 and _rot_err(R, np.asarray(jR)) < 1e-3
    bound = (ids >= 0) | (jids >= 0)
    assert (ids[bound] == jids[bound]).mean() >= 0.95


def test_blackout_through_process(jax_run, scenario):
    """The port's own map and database through the whole scenario."""
    jcfg, _, jat, jerr = jax_run
    frames, returning, poses = scenario
    tr = port_tracker(convert.config_from_dict(dataclasses.asdict(jcfg)))
    lost, at, err = run_blackout(tr, frames, returning, poses)
    assert lost == ttracking.LOST
    assert at == jat  # the JAX package relocalized on the same return frame
    assert err < 0.05 and abs(err - jerr) < 5e-3, (err, jerr)
    assert tr.kfdb.has[:tr.map.n_kf].sum() == tr.map.kf_valid[:tr.map.n_kf].sum() >= 2
    # reset clears the database and the relocalization state
    tr._speed_est, tr.vo_mode = 0.1, True
    tr.reset()
    assert not tr.kfdb.has.any() and tr._speed_est is None and not tr.vo_mode
