"""Map checkpoints and compaction of the port against the JAX package's
(CPU, 320x240):

- a map saved by the port's System loads in the JAX package's ``load_map``
  and in the port's, with tests/test_checkpoint.py::test_save_load_roundtrip's
  checks (keyframes, landmarks, observations, descriptors from the device
  arena, keyframe snapshots with their descriptors); a save of the JAX
  package loads in the port's (the JAX package's own map is checked in
  tests/test_torch_system.py);
- ``SlamMap.compact`` of a small map, with descriptor rows staged on the
  host before and after the device arena exists, equals the JAX package's
  (flushed first, see the test): id maps, arrays, observations and the
  device descriptor rows;
- tests/test_checkpoint.py::test_arena_compaction_mid_run in the port:
  compaction mid-run reclaims the erased slots, the observation tables stay
  consistent and tracking goes on.
"""

import dataclasses

import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_tpu.utils import checkpoint as jcheckpoint
from plslam_torch import convert
from plslam_torch.models.map import SlamMap
from plslam_torch.models.system import System
from plslam_torch.models.tracking import OK
from plslam_torch.utils import checkpoint
from torch_parity import KW, render
from torch_parity import few_torch_threads  # noqa: F401

N_MAP, N_MORE = 10, 6


@pytest.fixture(scope="module")
def frames():
    return render(N_MAP + N_MORE)


@pytest.fixture(scope="module")
def mapped(frames, tmp_path_factory):
    """A port System (synchronous workers, loop closing on) after N_MAP
    frames, and its map saved by the port."""
    cfg = convert.config_from_dict(dataclasses.asdict(JSlamConfig(camera=JCamera(**KW))))
    slam = System(cfg, device="cpu")
    for i, (g, d) in enumerate(frames[:N_MAP]):
        slam.track_rgbd(g, d, i / 30.0)
    path = str(tmp_path_factory.mktemp("ckpt") / "port_map.npz")
    slam.save_map(path)
    return slam, path


def _check_roundtrip(m1, m2, desc2):
    """test_save_load_roundtrip's checks: ``m2`` loaded from a save of
    ``m1``; ``desc2`` is m2's point descriptor arena as numpy."""
    assert m2.n_kf == m1.n_kf >= 2
    assert m2.n_points() == m1.n_points() > 500
    assert m2.n_lines() == m1.n_lines()
    assert m2._pt_next == m1._pt_next
    np.testing.assert_array_equal(m2.kf_valid, m1.kf_valid)
    np.testing.assert_allclose(m2.kf_R[: m1.n_kf], m1.kf_R[: m1.n_kf])
    np.testing.assert_array_equal(m2.kf_pt_idx, m1.kf_pt_idx)
    for pid in m1.point_ids()[:200]:
        assert m2.pt_obs[pid] == m1.pt_obs[pid]
    pid = m1.point_ids()[0]
    d1 = np.asarray(m1.point_desc_arena().cpu() if isinstance(m1, SlamMap)
                    else m1.point_desc_arena())
    assert d1[pid].any()
    np.testing.assert_array_equal(desc2[: m1._pt_next], d1[: m1._pt_next])
    kf = int(np.nonzero(m1.kf_valid)[0][0])
    assert m2.kf_frames[kf].kp_desc.any()
    assert [sorted(c) for c in m2.kf_children[: m1.n_kf]] == \
        [sorted(c) for c in m1.kf_children[: m1.n_kf]]


def test_port_save_loads_in_jax(mapped):
    slam, path = mapped
    jm = jcheckpoint.load_map(JSlamConfig(camera=JCamera(**KW)), path)
    _check_roundtrip(slam.map, jm, np.asarray(jm.point_desc_arena()))


def test_port_save_loads_in_port(mapped):
    slam, path = mapped
    m2 = checkpoint.load_map(slam.cfg, path, device="cpu")
    _check_roundtrip(slam.map, m2, m2.point_desc_arena().numpy())
    assert m2.kf_frames_dev[0] is None  # uploaded on first use
    fd = m2.device_frame(0)
    np.testing.assert_array_equal(fd.kp_desc.numpy(), slam.map.device_frame(0).kp_desc.numpy())


def test_jax_save_loads_in_port(mapped, tmp_path):
    slam, path = mapped
    jm = jcheckpoint.load_map(JSlamConfig(camera=JCamera(**KW)), path)
    jpath = str(tmp_path / "jax_map.npz")
    jcheckpoint.save_map(jm, jpath)
    m2 = checkpoint.load_map(slam.cfg, jpath, device="cpu")
    _check_roundtrip(jm, m2, m2.point_desc_arena().numpy())


def _small_maps(upload_first: bool):
    """The same small map in both packages: 3 keyframe rows, 40 points and
    12 lines with host-authored descriptors, every third point and line
    erased. With ``upload_first`` the device arenas exist (and half the
    rows were flushed) before the erasures."""
    jcfg = JSlamConfig(camera=JCamera(**KW))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    cap = dataclasses.replace(cfg.capacity, max_points=64, max_lines=16, max_keyframes=4)
    cfg = cfg.replace(capacity=cap)
    jcfg = jcfg.replace(capacity=dataclasses.replace(jcfg.capacity, max_points=64,
                                                     max_lines=16, max_keyframes=4))
    out = []
    for m in (SlamMap(cfg, device="cpu"), JSlamMap(jcfg)):
        m.n_kf = 3
        m.kf_valid[:3] = True
        r = np.random.default_rng(3)
        for i in range(40):
            pid = m.add_point(r.normal(size=3), r.integers(0, 256, 32, dtype=np.uint8),
                              np.array([0, 0, 1.0]), 0.5, 4.0, i % 3)
            for kf in range(3):
                if (i + kf) % 2 == 0:
                    m.add_point_obs(pid, kf, i)
            if upload_first and i == 20:
                m.point_desc_arena()
        for i in range(12):
            lid = m.add_line(r.normal(size=(2, 3)), r.integers(0, 256, 72, dtype=np.uint8), 0)
            m.add_line_obs(lid, i % 3, i)
            if upload_first and i == 6:
                m.line_desc_arena()
        for i in range(0, 40, 3):
            m.erase_point(i)
        for i in range(1, 12, 3):
            m.erase_line(i)
        out.append(m)
    return out


@pytest.mark.parametrize("upload_first", [False, True])
def test_compact_small_map_matches_jax(upload_first):
    m, jm = _small_maps(upload_first)
    assert (m._pt_desc_dev is not None) == upload_first
    assert m._pt_desc_dirty and m._ln_desc_dirty
    # the JAX package's compact gathers its device arena without flushing
    # the rows staged on the host first (their ids then point at moved
    # rows); no path of either package stages rows, but this map does, so
    # the JAX side is flushed before it compacts. The port flushes itself.
    jm.point_desc_arena()
    jm.line_desc_arena()
    pt_map, ln_map = m.compact()
    jpt_map, jln_map = jm.compact()
    np.testing.assert_array_equal(pt_map, jpt_map)
    np.testing.assert_array_equal(ln_map, jln_map)
    assert (m._pt_next, m._ln_next) == (jm._pt_next, jm._ln_next) == (26, 8)
    for name in convert._ARRAYS:
        np.testing.assert_array_equal(getattr(m, name), np.asarray(getattr(jm, name)), name)
    assert m.pt_obs == jm.pt_obs and m.ln_obs == jm.ln_obs
    np.testing.assert_array_equal(m.point_desc_arena().numpy()[:26],
                                  np.asarray(jm.point_desc_arena())[:26])
    np.testing.assert_array_equal(m.line_desc_arena().numpy()[:8],
                                  np.asarray(jm.line_desc_arena())[:8])
    assert not m.point_desc_arena().numpy()[26:].any()
    np.testing.assert_array_equal(m.point_desc_arena().numpy()[:26], m.pt_desc[:26])


def test_arena_compaction_mid_run(mapped, frames):
    """Runs last: it goes on with the fixture's System."""
    slam, _ = mapped
    m = slam.map
    n_valid = m.n_points()
    assert m._pt_next > n_valid  # some points were culled or merged
    pt_next = m._pt_next
    desc = m.point_desc_arena().clone()
    old_ids = m.point_ids()
    slam.compact_map()
    assert m._pt_next == m.n_points() == n_valid
    torch.testing.assert_close(m.point_desc_arena()[:n_valid], desc[torch.as_tensor(old_ids)])
    for pid in m.point_ids():
        for kf, feat in m.pt_obs[pid].items():
            assert m.kf_pt_idx[kf, feat] == pid
    tr = slam.tracker
    assert (tr.last_pt_ids < n_valid).all() and (tr._lp_ids < n_valid).all()
    assert pt_next > n_valid
    ok = 0
    for i, (g, d) in enumerate(frames[N_MAP:]):
        ok += slam.track_rgbd(g, d, (N_MAP + i) / 30.0) is not None
    slam.shutdown()
    assert slam.tracking_state == OK
    assert ok >= N_MORE - 2
