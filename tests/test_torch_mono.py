"""plslam_torch's monocular sensor against the JAX package's, at 320x240.

The frames are the room's orbit at 80 frames a turn (tests/test_mono.py's
speed). The H / F RANSAC draws are the JAX package's own: the port's
``find_models`` is wrapped to take the index sets ``jax.random.choice``
draws from ``PRNGKey(frame_id)``, the key JAX's tracker passes (the port
seeds its generator with the same frame id).

1. ``mono_init_match`` on the same FrameData in both packages:
   indices and masks equal.
2. ``_monocular_initialization`` through ``Tracker.process_mono`` without
   a mapper: the same bootstrap frame, both keyframe poses within 1e-4,
   the same landmark count, positions within 1e-3 relative.
3. Fifteen frames (twelve after the bootstrap) with a synchronous
   ``LocalMapper``, the JAX side's local BA in float64 as the port solves:
   every frame after the bootstrap tracks, the keyframe and landmark counts
   are equal, and the camera centres agree within 5e-3 map units (the
   bootstrap scales the median depth to 1).
4. Three identical frames leave both trackers NOT_INITIALIZED with no
   keyframe.
5. The System facade: a monocular System turns ``fix_scale`` off and
   bootstraps through ``track_monocular``; a call for another sensor
   raises ``RuntimeError``; an unknown sensor raises ``ValueError``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_torch import convert
from plslam_torch.models import frame as tframe
from plslam_torch.models import tracking as ttracking
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.map import SlamMap
from plslam_torch.models.system import System
from plslam_torch.ops import initializer as tinit
from test_torch_initializer import injected
from torch_parity import KW, jax_ba_in_float64, render
from torch_parity import few_torch_threads  # noqa: F401

N_FRAMES = 15
POSE_TOL = 1e-4
POINT_RTOL = 1e-3
SEQ_TOL = 5e-3


@pytest.fixture(scope="module")
def frames():
    return [g for g, _ in render(N_FRAMES, total=80)]


@pytest.fixture(scope="module")
def cfgs():
    jcfg = JSlamConfig(camera=JCamera(**KW))
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's find_models on the JAX package's draws for the frame id
    its generator was seeded with."""
    orig = tinit.find_models
    calls = []

    def with_jax_draws(uv1, uv2, valid, generator=None, **kw):
        calls.append(generator.initial_seed())
        return orig(uv1, uv2, valid, samples=injected(valid.numpy(), generator.initial_seed()))

    monkeypatch.setattr(tinit, "find_models", with_jax_draws)
    return calls


def _trackers(cfgs, mapper):
    jcfg, cfg = cfgs
    jm = JSlamMap(jcfg)
    m = SlamMap(cfg, device="cpu")
    jt = jtracking.Tracker(jcfg, jm, local_mapper=JLocalMapper(jcfg, jm) if mapper else None,
                           sensor="mono")
    tr = ttracking.Tracker(cfg, m, local_mapper=LocalMapper(cfg, m) if mapper else None,
                           sensor="mono")
    return jt, tr


def test_mono_init_match_matches_jax(cfgs, frames):
    jcfg, cfg = cfgs
    zero = torch.zeros((KW["height"], KW["width"]))
    f0, f3 = (tframe.build_frame(torch.from_numpy(frames[i]), zero, cfg) for i in (0, 3))
    args = [x.numpy() for x in (f0.kp_xy_un, f0.kp_desc, f0.kp_valid,
                                f3.kp_xy_un, f3.kp_desc, f3.kp_valid)]
    jidx, jok = (np.asarray(x) for x in jtracking.mono_init_match(jcfg, *map(jnp.asarray, args)))
    tidx, tok = ttracking.mono_init_match(cfg, *map(torch.from_numpy, args))
    assert jok.sum() >= 100  # enough for a bootstrap
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(tidx.numpy(), jidx)


def test_bootstrap_matches_jax(cfgs, frames, jax_draws):
    jt, tr = _trackers(cfgs, mapper=False)
    for i, g in enumerate(frames):
        jt.process_mono(g, i / 30.0)
        tr.process_mono(g, i / 30.0)
        assert tr.state == jt.state, i
        if jt.state == jtracking.OK:
            break
    assert jt.state == jtracking.OK, "no bootstrap"
    assert jax_draws[-1] == i  # the generator was seeded with the frame id
    assert tr.mono_init_stats["frame"] == i and tr.mono_init_stats["clear"]
    jm, m = jt.map, tr.map
    assert m.n_kf == jm.n_kf == 2
    np.testing.assert_allclose(m.kf_R[:2], jm.kf_R[:2], atol=POSE_TOL)
    np.testing.assert_allclose(m.kf_t[:2], jm.kf_t[:2], atol=POSE_TOL)
    pids = jm.point_ids()
    assert len(pids) >= 80
    np.testing.assert_array_equal(m.point_ids(), pids)
    np.testing.assert_allclose(m.pt_pos[pids], jm.pt_pos[pids], rtol=POINT_RTOL, atol=1e-6)
    np.testing.assert_array_equal(m.kf_pt_idx[:2], jm.kf_pt_idx[:2])
    assert tr._mono_ref is None and jt._mono_ref is None
    assert len(tr.trajectory) == len(jt.trajectory) == 2


def _centers(traj):
    return np.array([-(R.T @ t) for _, R, t in traj])


def test_mono_sequence_matches_jax(cfgs, frames, jax_draws):
    jt, tr = _trackers(cfgs, mapper=True)
    boot = None
    with jax_ba_in_float64():
        for i, g in enumerate(frames):
            jt.process_mono(g, i / 30.0)
            tr.process_mono(g, i / 30.0)
            assert tr.state == jt.state, i
            if boot is None and tr.state == ttracking.OK:
                boot = i
            if boot is not None:
                assert tr.state == ttracking.OK, i
        jt.flush()
        tr.flush()
    assert boot is not None and N_FRAMES - boot >= 12
    jm, m = jt.map, tr.map
    assert m.n_kf == jm.n_kf >= 3
    assert m.n_points() == jm.n_points() > 100
    assert len(tr.trajectory) == len(jt.trajectory) == N_FRAMES - boot + 1
    err = np.linalg.norm(_centers(tr.trajectory) - _centers(jt.trajectory), axis=1)
    assert err.max() < SEQ_TOL, err


def test_no_parallax_is_rejected(cfgs, frames):
    """Identical frames give no baseline: neither package bootstraps."""
    jt, tr = _trackers(cfgs, mapper=False)
    for i in range(3):
        jt.process_mono(frames[0], i / 30.0)
        tr.process_mono(frames[0], i / 30.0)
    assert tr.state == jt.state == ttracking.NOT_INITIALIZED
    assert tr.map.n_kf == jt.map.n_kf == 0
    assert tr._mono_ref is not None  # the reference frame is held


def test_system_sensors(cfgs, frames):
    _, cfg = cfgs
    assert cfg.loop.fix_scale
    slam = System(cfg, sensor="mono", async_mapping=False, device="cpu")
    assert slam.cfg.loop.fix_scale is False
    assert slam.loop_closer.cfg.loop.fix_scale is False
    assert slam.tracker.sensor == "mono"
    with pytest.raises(RuntimeError):
        slam.track_stereo(frames[0], frames[0], 0.0)
    for i, g in enumerate(frames[:6]):
        slam.track_monocular(g, i / 30.0)
    assert slam.tracking_state == ttracking.OK
    assert slam.map.n_kf >= 2
    slam.shutdown()
    stereo = System(cfg, sensor="stereo", device="cpu")
    assert stereo.cfg.loop.fix_scale is True
    with pytest.raises(RuntimeError):
        stereo.track_monocular(frames[0], 0.0)
    with pytest.raises(ValueError):
        System(cfg, sensor="rgb", device="cpu")
    with pytest.raises(ValueError):
        ttracking.Tracker(cfg, SlamMap(cfg, device="cpu"), sensor="depth")
