"""plslam_torch.parallel.ba (the landmark-sharded BA) and
utils.synthetic.make_synthetic_ba_map against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port puts S shards on the CPU (``[cpu] * S``). Inputs are
``tests/test_parallel.py::small_problem`` (numpy-seeded).

- ``shard_problem`` / ``unshard_points`` and the synthetic GBA map are
  exactly equal to JAX's (the map's perturbed poses to 1e-6: the port's
  ``se3.left_update`` rounds the last bit differently, 6e-8 measured).
- One ``distributed_gn_step`` / ``distributed_cg_step`` on S = 4 shards
  equals JAX's on a 4-device mesh at 1e-5 relative, the JAX step run in
  float64 (``jax.enable_x64``) as the port solves (the pattern of
  tests/test_torch_ba_cg.py); against the JAX step as it ships (float32)
  at the gap its own float32 solve leaves (2.5e-5 relative measured on
  seed 0: that is JAX float32 against JAX float64), bounded at 1e-4.
- Float64 inputs against JAX under x64 at 1e-9, S = 4 against the port's
  S = 1 (Schur exactness) at 1e-9.
- ``distributed_bundle_adjust`` halves the pose error and aborts after 2
  steps; the engine route on the 72-keyframe map with 8 CPU shards against
  JAX's engine route and the port's PCG route: poses within 5 mm, mean
  error < 1 cm, ``run_local_ba`` returns "distributed".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from plslam_tpu.config import SlamConfig as JConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plslam_tpu.parallel import ba as jpba
from plslam_tpu.utils.synthetic import make_synthetic_ba_map as jmake
from plslam_torch import convert
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.optim import local_ba
from plslam_torch.parallel import ba as tpba
from plslam_torch.parallel.mesh import make_ba_mesh
from plslam_torch.utils.synthetic import make_synthetic_ba_map as tmake
from test_parallel import CAM, small_problem
from torch_parity import few_torch_threads  # noqa: F401

TCAM = convert.Camera(*CAM)
CPU = torch.device("cpu")
STEPS = {"gn": (jpba.distributed_gn_step, tpba.distributed_gn_step, {}),
         "cg": (jpba.distributed_cg_step, tpba.distributed_cg_step, dict(cg_iters=32))}


def _jmesh(S):
    return Mesh(np.array(jax.devices()[:S]).reshape(S), ("obs",))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(a)).max())


def _f64(prob):
    return type(prob)(*(np.asarray(x).astype(np.float64) if np.asarray(x).dtype == np.float32
                        else np.asarray(x) for x in prob))


@pytest.fixture(scope="module")
def problem():
    return small_problem(np.random.default_rng(0))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_shard_and_unshard_equal_jax(problem, S):
    args, _, _ = problem
    jp = jpba.shard_problem(*args, n_shards=S)
    tp = tpba.shard_problem(*args, n_shards=S)
    for name, a, b in zip(tp._fields, jp, tp):
        assert np.asarray(a).dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    Xs = np.random.default_rng(S).normal(size=tp.pt_xyz.shape).astype(np.float32)
    n = len(args[3])
    np.testing.assert_array_equal(tpba.unshard_points(Xs, n), jpba.unshard_points(Xs, n))


def test_synthetic_ba_map_equals_jax():
    jcfg = JConfig(camera=JCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jm, jgt, jpts = jmake(jcfg, n_kf=12, n_pts=80, obs_per_kf=40, seed=2)
    tm, tgt, tpts = tmake(tcfg, n_kf=12, n_pts=80, obs_per_kf=40, seed=2, device="cpu")
    np.testing.assert_array_equal(jpts, tpts)
    for (Ra, ta), (Rb, tb) in zip(jgt, tgt):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)
    assert jm.n_kf == tm.n_kf == 12
    np.testing.assert_allclose(tm.kf_R[:12], jm.kf_R[:12], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.kf_t[:12], jm.kf_t[:12], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.pt_pos, jm.pt_pos)
    np.testing.assert_array_equal(tm.pt_valid, jm.pt_valid)
    np.testing.assert_array_equal(tm.kf_pt_idx, jm.kf_pt_idx)
    assert tm.pt_obs[:80] == jm.pt_obs[:80]
    for k in range(12):
        for f in ("kp_xy", "kp_xy_un", "kp_ur", "kp_valid"):
            np.testing.assert_array_equal(getattr(tm.kf_frames[k], f),
                                          getattr(jm.kf_frames[k], f))


@pytest.mark.parametrize("step", ["gn", "cg"])
def test_step_matches_jax(problem, step):
    """S = 4 shards against JAX's 4-device step: float32 inputs, the JAX
    step in float64 as the port solves, at 1e-5 relative; and against the
    JAX step in float32 as it ships, at the gap of its float32 solve."""
    args, _, _ = problem
    jf, tf, kw = STEPS[step]
    jp = jpba.shard_problem(*args, n_shards=4)
    tp = tpba.shard_problem(*args, n_shards=4)
    out = tf(TCAM, tp, make_ba_mesh([CPU] * 4), **kw)
    assert all(x.dtype == torch.float32 for x in out)
    with jax.enable_x64(True):
        ref = [np.asarray(x) for x in jf(CAM, jpba.ShardedBA(*(jnp.asarray(x) for x in _f64(jp))),
                                         _jmesh(4), **kw)]
    for a, b in zip(ref, out):
        assert _rel(a, b.numpy()) <= 1e-5
    shipped = [np.asarray(x) for x in jf(CAM, jp, _jmesh(4), **kw)]
    for a, b in zip(shipped, out):
        assert _rel(a, b.numpy()) <= 1e-4


@pytest.mark.parametrize("step", ["gn", "cg"])
def test_step_float64_matches_jax_x64(problem, step):
    args, _, _ = problem
    jf, tf, kw = STEPS[step]
    p64 = _f64(tpba.shard_problem(*args, n_shards=4))
    with jax.enable_x64(True):
        ref = [np.asarray(x) for x in jf(CAM, jpba.ShardedBA(*(jnp.asarray(x) for x in p64)),
                                         _jmesh(4), **kw)]
    out = tf(TCAM, p64, make_ba_mesh([CPU] * 4), **kw)
    for a, b in zip(ref, out):
        assert b.dtype == torch.float64
        assert _rel(a, b.numpy()) <= 1e-9


@pytest.mark.parametrize("step", ["gn", "cg"])
def test_sharded_equals_single_shard(problem, step):
    """Exactness of the Schur decomposition over landmark blocks: the camera
    update of 4 shards is the update of 1."""
    args, _, _ = problem
    _, tf, kw = STEPS[step]
    p1 = _f64(tpba.shard_problem(*args, n_shards=1))
    p4 = _f64(tpba.shard_problem(*args, n_shards=4))
    R1, t1, X1 = tf(TCAM, p1, make_ba_mesh([CPU]), **kw)
    R4, t4, X4 = tf(TCAM, p4, make_ba_mesh([CPU] * 4), **kw)
    assert _rel(R1, R4) <= 1e-9 and _rel(t1, t4) <= 1e-9
    n = len(args[3])
    assert _rel(tpba.unshard_points(X1.numpy(), n), tpba.unshard_points(X4.numpy(), n)) <= 1e-9


def _ba_problem(args):
    (cam_R, cam_t, fixed, pts0, pt_valid, obs_cam, obs_pt, obs_uv, obs_ur, obs_w,
     obs_val) = args
    C, P, O = len(cam_R), len(pts0), len(obs_cam)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    return local_ba.make_problem(C, P, O, 1, 1, device="cpu")._replace(
        cam_R=t(cam_R), cam_t=t(cam_t), cam_fixed=t(fixed), cam_valid=torch.ones(C, dtype=bool),
        pt_xyz=t(pts0), pt_valid=t(pt_valid), obs_cam=t(obs_cam, torch.int64),
        obs_pt=t(obs_pt, torch.int64), obs_uv=t(obs_uv), obs_ur=t(obs_ur), obs_w=t(obs_w),
        obs_valid=t(obs_val))


def _cam_err(R, t, poses):
    return float(np.mean([np.linalg.norm(-R[i].T @ t[i] + Rg.T @ tg)
                          for i, (Rg, tg) in enumerate(poses)]))


def test_bundle_adjust_halves_pose_error():
    args, poses, _ = small_problem(np.random.default_rng(1))
    prob = _ba_problem(args)
    Rn, tn, Xn, inl = tpba.distributed_bundle_adjust(TCAM, prob, make_ba_mesh([CPU] * 4),
                                                     iters=4, cg_iters=32)
    assert Rn.dtype == np.float32 and Xn.shape == (len(args[3]), 3)
    assert _cam_err(Rn, tn, poses) < 0.5 * _cam_err(args[0], args[1], poses)
    assert inl.sum() > 0.9 * args[10].sum()


def test_bundle_adjust_aborts_after_two_steps(monkeypatch):
    args, _, _ = small_problem(np.random.default_rng(5))
    calls = []
    real_step = tpba.distributed_cg_step

    def counting_step(*a, **kw):
        calls.append(1)
        return real_step(*a, **kw)

    monkeypatch.setattr(tpba, "distributed_cg_step", counting_step)
    Rn, tn, Xn, inl = tpba.distributed_bundle_adjust(
        TCAM, _ba_problem(args), make_ba_mesh([CPU] * 4), iters=8, cg_iters=16,
        should_abort=lambda: len(calls) >= 2)
    assert len(calls) == 2
    assert Rn.shape == (len(args[0]), 3, 3) and inl.sum() > 0


def _pose_err(m, gt):
    return np.array([np.linalg.norm(-(m.kf_R[k].T @ m.kf_t[k]) + R.T @ t)
                     for k, (R, t) in enumerate(gt) if m.kf_valid[k]])


GBA = dict(window=128, obs_cap=1 << 14, point_cap=512)
MAP = dict(n_kf=72, n_pts=260, obs_per_kf=72, seed=3)


@pytest.fixture(scope="module")
def jax_engine_gba():
    jcfg = JConfig(camera=JCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    m, gt, _ = jmake(jcfg, **MAP)
    JLocalMapper(jcfg, m).run_local_ba(0, **GBA)  # 72 cameras: the 8-device mesh
    return jcfg, m, gt


def test_engine_route_distributed(jax_engine_gba):
    jcfg, jm, gt = jax_engine_gba
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    m0, _, _ = tmake(cfg, device="cpu", **MAP)
    e0 = _pose_err(m0, gt).mean()
    m, _, _ = tmake(cfg, device="cpu", **MAP)
    mapper = LocalMapper(cfg, m)
    mapper.ba_mesh = make_ba_mesh([CPU] * 8)
    assert mapper.run_local_ba(0, **GBA) == "distributed"
    pm, _, _ = tmake(cfg, device="cpu", **MAP)
    assert LocalMapper(cfg, pm).run_local_ba(0, **GBA) == "pcg"  # one CPU shard
    err = _pose_err(m, gt)
    assert err.mean() < 0.01 and err.mean() < 0.5 * e0
    for other in (jm, pm):
        assert np.linalg.norm(m.kf_t[:72] - other.kf_t[:72], axis=1).max() < 5e-3
    np.testing.assert_array_equal(m.kf_pt_idx, jm.kf_pt_idx)  # the same outliers erased
