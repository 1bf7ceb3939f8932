"""plslam_torch.models.system.System against the JAX package's System
(CPU, 320x240, the same 10 rendered frames, synchronous workers, loop
closing on, tracing on):

- the healed TUM trajectories agree row for row within 5 mm and 5e-3 rad,
  the keyframe and KITTI files have the same rows;
- the "frame" trace records carry the JAX package's fields, with the same
  frame, state, keyframe and map-size values;
- the JAX System's map, carried over with ``convert``, compacts in both
  packages to the same id maps, arrays and device descriptor rows, and its
  JAX checkpoint loads in the port;

and, port-only: localization mode does not grow the map, the viewer draws
the map and the status bar, a save -> load -> relocalize round trip, and
the sensors (ROADMAP item 16): a monocular System turns ``fix_scale`` off,
and an RGB-D System's stereo and monocular entry points raise.
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models.system import System as JSystem
from plslam_torch import convert
from plslam_torch.geometry import se3
from plslam_torch.models.system import System
from plslam_torch.models.tracking import LOST, OK
from plslam_torch.utils import checkpoint, tum_io, viewer
from plslam_torch.utils.synthetic import smooth_trajectory
from torch_parity import KW, map_arrays, render
from torch_parity import few_torch_threads  # noqa: F401

N = 10
POS_TOL, ROT_TOL = 5e-3, 5e-3


@pytest.fixture(scope="module")
def frames():
    return render(N + 4)


@pytest.fixture(scope="module")
def systems(frames, tmp_path_factory):
    """(JAX System, port System, trace directory) after the same N frames."""
    d = tmp_path_factory.mktemp("system")
    jcfg = JSlamConfig(camera=JCamera(**KW))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jslam = JSystem(jcfg, trace_path=str(d / "jax.jsonl"))
    slam = System(cfg, trace_path=str(d / "port.jsonl"), device="cpu")
    for i, (g, dep) in enumerate(frames[:N]):
        jslam.track_rgbd(g, dep, i / 30.0)
        slam.track_rgbd(g, dep, i / 30.0)
    for s in (jslam, slam):
        s.tracker.flush()
    return jslam, slam, d


def _angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def test_healed_trajectories_match_jax(systems):
    jslam, slam, d = systems
    for name in ("traj", "kf", "kitti"):
        for s, who in ((jslam, "jax"), (slam, "port")):
            path = str(d / f"{who}_{name}.txt")
            {"traj": s.save_trajectory_tum, "kf": s.save_keyframe_trajectory_tum,
             "kitti": s.save_trajectory_kitti}[name](path)
    jts, jpos, jq = tum_io.load_trajectory_tum(str(d / "jax_traj.txt"))
    ts, pos, q = tum_io.load_trajectory_tum(str(d / "port_traj.txt"))
    assert len(ts) == len(jts) == N
    np.testing.assert_array_equal(ts, jts)
    assert np.abs(pos - jpos).max() < POS_TOL
    R, jR = (se3.quat_to_rot(torch.from_numpy(v.astype(np.float32))).numpy() for v in (q, jq))
    assert max(_angle(a, b) for a, b in zip(R, jR)) < ROT_TOL
    assert np.all(np.abs(np.linalg.norm(q, axis=1) - 1) < 1e-3)
    kts, _, _ = tum_io.load_trajectory_tum(str(d / "port_kf.txt"))
    jkts, _, _ = tum_io.load_trajectory_tum(str(d / "jax_kf.txt"))
    np.testing.assert_array_equal(kts, jkts)
    rows = [line.split() for line in open(d / "port_kitti.txt")]
    assert len(rows) == N and all(len(r) == 12 for r in rows)
    # against the ground truth, as tests/test_system.py measures it
    gt = np.array([-R.T @ t for R, t in smooth_trajectory(300)[:N]])
    assert tum_io.ate_rmse(ts, pos, np.arange(N) / 30.0, gt) < 0.03


def test_frame_trace_records_match_jax(systems):
    _, _, d = systems
    recs = {}
    for who in ("jax", "port"):
        with open(d / f"{who}.jsonl") as f:
            recs[who] = [r for r in map(json.loads, f) if r["kind"] == "frame"]
    assert len(recs["port"]) == len(recs["jax"]) >= N - 2
    for r, jr in zip(recs["port"], recs["jax"]):
        assert list(r) == list(jr)
        assert {"frame", "state", "local_inliers", "n_kf"} <= set(r)
        for k in ("frame", "ts", "state", "kf", "n_kf"):
            assert r[k] == jr[k], (k, r, jr)
        assert abs(r["local_inliers"] - jr["local_inliers"]) <= 0.05 * jr["local_inliers"]
    assert any(r["kf"] for r in recs["port"])


def _jax_map_copy(jm):
    c = copy.copy(jm)
    for name in convert._ARRAYS:
        setattr(c, name, np.array(getattr(jm, name)))
    c.pt_obs = [dict(o) for o in jm.pt_obs]
    c.ln_obs = [dict(o) for o in jm.ln_obs]
    return c


def test_jax_system_map_compacts_as_in_jax(systems):
    jslam, slam, _ = systems
    jm = _jax_map_copy(jslam.map)
    m = convert.map_from_numpy(map_arrays(jslam.map), slam.cfg, device="cpu")
    assert jm._pt_next > jm.n_points()
    pt_map, ln_map = m.compact()
    jpt_map, jln_map = jm.compact()
    np.testing.assert_array_equal(pt_map, jpt_map)
    np.testing.assert_array_equal(ln_map, jln_map)
    assert (m._pt_next, m._ln_next) == (jm._pt_next, jm._ln_next)
    for name in convert._ARRAYS:
        np.testing.assert_array_equal(getattr(m, name), np.asarray(getattr(jm, name)), name)
    assert m.pt_obs == jm.pt_obs and m.ln_obs == jm.ln_obs
    n, nl = m._pt_next, m._ln_next
    np.testing.assert_array_equal(m.point_desc_arena().numpy()[:n],
                                  np.asarray(jm.point_desc_arena())[:n])
    np.testing.assert_array_equal(m.line_desc_arena().numpy()[:nl],
                                  np.asarray(jm.line_desc_arena())[:nl])


def test_jax_system_checkpoint_loads_in_port(systems, tmp_path):
    jslam, slam, _ = systems
    path = str(tmp_path / "jax_map.npz")
    jslam.save_map(path)
    jm = jslam.map
    m = checkpoint.load_map(slam.cfg, path, device="cpu")
    assert (m.n_kf, m.n_points(), m.n_lines()) == (jm.n_kf, jm.n_points(), jm.n_lines())
    np.testing.assert_array_equal(m.kf_R, np.asarray(jm.kf_R))
    pid = jm.point_ids()[0]
    assert m.pt_obs[pid] == jm.pt_obs[pid]
    d = np.asarray(jax.device_get(jm.point_desc_arena()))
    assert d[pid].any()
    np.testing.assert_array_equal(m.point_desc_arena().numpy(), d)
    kf = int(np.nonzero(jm.kf_valid)[0][0])
    np.testing.assert_array_equal(m.device_frame(kf).kp_desc.numpy(),
                                  np.asarray(jm.device_frame(kf).kp_desc))


def test_viewer_outputs(systems, tmp_path):
    _, slam, _ = systems
    out = tmp_path / "map.png"
    viewer.draw_map(slam.map, slam.tracker.trajectory, str(out), show_graph=True)
    assert out.exists() and out.stat().st_size > 1000
    bar = viewer.status_text(slam.tracker, slam.map)
    assert bar.startswith("SLAM MODE | KFs: ") and "MPs:" in bar and "Matches:" in bar
    frame = tmp_path / "frame.png"
    viewer.draw_frame(np.zeros((KW["height"], KW["width"]), np.uint8),
                      slam.map.device_frame(0), str(frame), status=bar)
    assert frame.stat().st_size > 1000


def test_save_load_relocalize(systems, frames, tmp_path):
    """tests/test_checkpoint.py::test_localization_against_loaded_map,
    small: the port's save, loaded into a localization-only System, which
    starts LOST, relocalizes and tracks without minting keyframes."""
    _, slam, _ = systems
    path = str(tmp_path / "map.npz")
    slam.save_map(path)
    loc = System(slam.cfg, localization_only=True, enable_loop_closing=False, device="cpu")
    loc.load_map(path)
    assert loc.tracking_state == LOST and loc.tracker.last_pose is None
    n_kf = loc.map.n_kf
    got = [loc.track_rgbd(g, d, 10.0 + i / 30.0) for i, (g, d) in enumerate(frames[3:N])]
    loc.shutdown()
    assert loc.tracking_state == OK
    assert got[0] is not None  # relocalized on the first frame
    assert sum(p is not None for p in got) >= len(got) - 2
    assert loc.map.n_kf == n_kf
    R, t = loc.tracker.last_pose
    R0, t0 = smooth_trajectory(300)[0]
    gR, gt = smooth_trajectory(300)[N - 1]
    assert np.linalg.norm(-R.T @ t - (R0 @ (-gR.T @ gt) + t0)) < 0.05


def test_localization_mode_does_not_grow_the_map(systems, frames):
    """Runs after the tests that read the fixture's System: it goes on
    with it."""
    _, slam, _ = systems
    n_kf, n_pt = slam.map.n_kf, slam.map.n_points()
    slam.activate_localization_mode()
    assert not slam.local_mapper.enable_ba and slam.tracker.only_tracking
    for i, (g, d) in enumerate(frames[N:]):
        out = slam.track_rgbd(g, d, (N + i) / 30.0)
        assert out is not None or i == 0  # lag-1: the pipeline was drained
    assert slam.map.n_kf == n_kf
    assert abs(slam.map.n_points() - n_pt) <= 2
    slam.deactivate_localization_mode()
    assert slam.local_mapper.enable_ba and not slam.tracker.only_tracking
    assert not slam.map_changed()
    slam.map.big_change_idx += 1
    assert slam.map_changed() and not slam.map_changed()
    slam.shutdown()


def test_mono_and_stereo_name_item_16(systems):
    _, slam, _ = systems
    mono = System(slam.cfg, sensor="mono", device="cpu")
    assert mono.tracker.sensor == "mono" and mono.cfg.loop.fix_scale is False
    assert slam.cfg.loop.fix_scale is True
    with pytest.raises(RuntimeError, match="stereo"):
        slam.track_stereo(None, None, 0.0)
    with pytest.raises(RuntimeError, match="mono"):
        slam.track_monocular(None, 0.0)
