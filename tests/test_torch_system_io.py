"""The port's trajectory I/O, evaluation, tracing and GC tuning against the
JAX package's (CPU):

- ``geometry.se3.rot_to_quat`` on 200 seeded rotations, near-180° ones
  (every branch of the four candidates) included, to 2e-7 (in practice
  bit for bit), and ``quat_to_rot`` to 1e-6;
- TUM and KITTI files written by both packages from the same poses are
  byte-equal;
- ``tum_io.load_trajectory_tum`` / ``ate_rmse`` and ``evaluate.associate``
  / ``umeyama_alignment`` / ``ate_rmse`` equal to 1e-9;
- the ``Tracer`` record format, and the ``gctune`` state round trip.
"""

import gc
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.utils import evaluate as jevaluate
from plslam_tpu.utils import tracing as jtracing
from plslam_tpu.utils import tum_io as jtum_io
from plslam_torch.geometry import se3
from plslam_torch.utils import evaluate, gctune, tracing, tum_io


def _rotations():
    """150 uniform rotations and 50 within 1e-3 rad of a half turn (the
    trace is then ~-1 and one of the three diagonal candidates wins), as
    float32, plus the identity and exact half turns about each axis."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(50, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.pi - rng.uniform(0.0, 1e-3, 50)
    R = np.concatenate([Rotation.random(150, random_state=1).as_matrix(),
                        Rotation.from_rotvec(axes * angles[:, None]).as_matrix(),
                        np.eye(3)[None], np.diag([1.0, -1, -1])[None],
                        np.diag([-1.0, 1, -1])[None], np.diag([-1.0, -1, 1])[None]])
    return R.astype(np.float32)


def _poses(n=40, seed=2):
    rng = np.random.default_rng(seed)
    Rs = _rotations()[rng.permutation(len(_rotations()))[:n]]
    ts = rng.normal(scale=2.0, size=(n, 3))
    return [(R, t) for R, t in zip(Rs, ts)]


def test_rot_to_quat_matches_jax():
    R = _rotations()
    want = np.stack([np.asarray(jse3.rot_to_quat(jnp.asarray(r))) for r in R])
    got = se3.rot_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    one = se3.rot_to_quat(torch.from_numpy(R[7])).numpy()  # unbatched
    np.testing.assert_allclose(one, want[7], rtol=0, atol=2e-7)
    # every candidate construction was exercised
    scores = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
                       -R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2],
                       -R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2]], 1)
    assert set(np.argmax(scores, 1)) == {0, 1, 2, 3}


def test_quat_to_rot_matches_jax():
    q = np.stack([np.asarray(jse3.rot_to_quat(jnp.asarray(r))) for r in _rotations()])
    q[::3] *= 1.7  # a non-unit quaternion takes the same rotation
    want = np.stack([np.asarray(jse3.quat_to_rot(jnp.asarray(v))) for v in q])
    got = se3.quat_to_rot(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:150], _rotations()[:150], atol=2e-6)


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_files_byte_equal(tmp_path, fmt):
    poses = _poses()
    ts = [1305031102.175304 + i / 30.0 for i in range(len(poses))]
    a, b = tmp_path / "jax.txt", tmp_path / "port.txt"
    if fmt == "tum":
        jtum_io.save_trajectory_tum(str(a), ts, poses)
        tum_io.save_trajectory_tum(str(b), ts, poses)
    else:
        jtum_io.save_trajectory_kitti(str(a), poses)
        tum_io.save_trajectory_kitti(str(b), poses)
    assert a.read_bytes() == b.read_bytes()
    assert len(b.read_text().splitlines()) == len(poses)


def test_load_trajectory_and_ate_match_jax(tmp_path):
    poses = _poses()
    ts = np.arange(len(poses)) / 30.0
    path = str(tmp_path / "traj.txt")
    tum_io.save_trajectory_tum(path, ts, poses)
    with open(path, "a") as f:
        f.write("# a comment line\n\n")
    got = tum_io.load_trajectory_tum(path)
    want = jtum_io.load_trajectory_tum(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(5)
    gt_ts = np.arange(0, len(poses) + 5) / 30.0 + rng.uniform(-0.005, 0.005, len(poses) + 5)
    gt_pos = got[1][np.clip(np.arange(len(gt_ts)), 0, len(poses) - 1)] \
        + rng.normal(scale=0.01, size=(len(gt_ts), 3))
    a = tum_io.ate_rmse(got[0], got[1], gt_ts, gt_pos)
    b = jtum_io.ate_rmse(got[0], got[1], gt_ts, gt_pos)
    assert abs(a - b) <= 1e-9 and 0 < a < 0.05


def test_evaluate_matches_jax():
    rng = np.random.default_rng(9)
    gt_ts = np.sort(rng.uniform(0, 10, 300))
    est_ts = gt_ts[::2] + rng.uniform(-0.03, 0.03, 150)
    assert evaluate.associate(est_ts, gt_ts) == jevaluate.associate(est_ts, gt_ts)
    gt_pos = rng.normal(size=(300, 3))
    R = Rotation.random(random_state=4).as_matrix()
    est_pos = (1.3 * gt_pos[::2] @ R.T + [0.5, -1.0, 2.0]
               + rng.normal(scale=0.01, size=(150, 3)))
    for with_scale in (False, True):
        s1, R1, t1 = evaluate.umeyama_alignment(est_pos, gt_pos[::2], with_scale)
        s2, R2, t2 = jevaluate.umeyama_alignment(est_pos, gt_pos[::2], with_scale)
        assert abs(s1 - s2) <= 1e-9
        np.testing.assert_allclose(R1, R2, rtol=0, atol=1e-9)
        np.testing.assert_allclose(t1, t2, rtol=0, atol=1e-9)
        r1, n1, st1 = evaluate.ate_rmse(gt_ts, gt_pos, est_ts, est_pos, with_scale=with_scale)
        r2, n2, st2 = jevaluate.ate_rmse(gt_ts, gt_pos, est_ts, est_pos, with_scale=with_scale)
        assert n1 == n2 > 100 and abs(r1 - r2) <= 1e-9
        assert st1.keys() == st2.keys()
        assert all(abs(st1[k] - st2[k]) <= 1e-9 for k in st1)
    traj = [(t, R.astype(np.float32), p.astype(np.float32)) for t, p in zip(est_ts, est_pos)]
    for g, w in zip(evaluate.trajectory_positions(traj), jevaluate.trajectory_positions(traj)):
        np.testing.assert_array_equal(g, w)


def test_tracer_records_match_jax(tmp_path):
    recs = []
    for mod, name in ((jtracing, "jax.jsonl"), (tracing, "port.jsonl")):
        path = str(tmp_path / name)
        tr = mod.Tracer(path)
        assert tr.enabled
        tr.emit("frame", frame=3, ts=0.1, state=1, local_inliers=250, kf=False, n_kf=2)
        tr.emit("reloc", frame=9, ts=np.float64(0.3), n_lost=2)
        tr.close()
        tr.emit("frame", frame=4)  # after close: dropped
        recs.append([json.loads(line) for line in open(path)])
    for r in recs:
        assert [x.pop("t") >= 0 for x in r] == [True, True]
    assert recs[0] == recs[1]
    assert list(recs[1][0]) == ["kind", "frame", "ts", "state", "local_inliers", "kf", "n_kf"]
    assert not tracing.NULL.enabled
    tracing.NULL.emit("frame", frame=0)  # a no-op


def test_gctune_round_trip():
    before = gc.get_threshold()
    frozen = gc.get_freeze_count()  # the interpreter's own permanent objects
    assert not gctune.is_tuned()
    try:
        gctune.tune_gc()
        gctune.tune_gc()  # idempotent
        assert gctune.is_tuned()
        assert gc.get_threshold() == (50000, 50, 10**9)
        assert gc.get_freeze_count() > frozen
        gctune.collect_old()
    finally:
        gctune.untune_gc()
    assert not gctune.is_tuned()
    assert gc.get_threshold() == before
    assert gc.get_freeze_count() == frozen
    gctune.untune_gc()  # idempotent
