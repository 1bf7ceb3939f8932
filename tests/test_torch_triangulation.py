"""plslam_torch.models.triangulation against the JAX package's.

The scenes of ``tests/test_triangulation.py`` (far points seen by two
keyframes with a wide baseline, 3D segments seen by two keyframes) go
through both packages from the same JAX-built map (carried by
``plslam_torch.convert``). At least 95% of the features either package
accepts are accepted by both, and shared landmarks agree within 1e-3 m.
The DLT null vector comes from each package's SVD (LAPACK here, cuSOLVER
on the card): its sign may differ and dehomogenising removes it, so
accepted sets and positions are compared, not raw vectors.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from plslam_tpu.models import triangulation as jtri
from plslam_tpu.models.map import HostFrame as JHostFrame
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_torch import convert
from plslam_torch.models import triangulation as ttri
from test_triangulation import CFG, _frame_arrays, _project
from torch_parity import map_arrays
from torch_parity import few_torch_threads  # noqa: F401

TCFG = convert.config_from_dict(dataclasses.asdict(CFG))


def _two_keyframe_map(fd1, fd2, R1, t1, R2, t2, shared_feats):
    m = JSlamMap(CFG)
    kf1 = m.add_keyframe(JHostFrame(fd1), R1, t1, 0, 0.0)
    kf2 = m.add_keyframe(JHostFrame(fd2), R2, t2, 1, 1.0)
    for f1, f2, pos in shared_feats:
        pid = m.add_point(pos, np.zeros(32, np.uint8), [0, 0, 1], 0.1, 50.0, kf1)
        m.add_point_obs(pid, kf1, f1)
        m.add_point_obs(pid, kf2, f2)
    return m, kf1, kf2


def _created(m, kf, n, ids, pos):
    """{feature: landmark position} of the landmarks bound at kf's first n
    features."""
    out = {}
    for f in range(n):
        i = m.kf_pt_idx[kf, f] if ids == "pt" else m.kf_ln_idx[kf, f]
        if i >= 0:
            out[f] = np.asarray(pos[i])
    return out


def _agree(a, b):
    both = set(a) & set(b)
    assert len(both) >= 0.95 * max(len(a), len(b)), (len(a), len(b), len(both))
    for f in both:
        assert np.abs(a[f] - b[f]).max() < 1e-3


def _far_point_scene():
    rng = np.random.default_rng(0)
    pw = rng.uniform([-3, -2, 8.0], [3, 2, 14.0], (60, 3)).astype(np.float32)
    desc = rng.integers(0, 256, (60, 32), np.uint8)
    R = np.eye(3, dtype=np.float32)
    t1, t2 = np.zeros(3, np.float32), np.array([-0.8, 0.0, 0.0], np.float32)
    uv1, _ = _project(R, t1, pw)
    uv2, _ = _project(R, t2, pw)
    vis = ((uv1[:, 0] > 0) & (uv1[:, 0] < 640) & (uv2[:, 0] > 0) & (uv2[:, 0] < 640)
           & (uv1[:, 1] > 0) & (uv1[:, 1] < 480))
    fd1 = _frame_arrays(uv1[vis].astype(np.float32), desc[vis])
    fd2 = _frame_arrays(uv2[vis].astype(np.float32), desc[vis])
    n = CFG.orb.max_keypoints
    # covisibility needs shared points: one dummy landmark (JAX test's setup)
    m, kf1, kf2 = _two_keyframe_map(fd1, fd2, R, t1, R, t2, [(n - 1, n - 1, [0, 0, 10.0])])
    return m, kf1, kf2, int(vis.sum())


def test_fundamental_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        Rs = [np.asarray(jtri.jnp.linalg.qr(jnp.asarray(rng.normal(size=(3, 3))))[0],
                         np.float32) for _ in (0, 1)]
        ts = [rng.normal(size=3).astype(np.float32) for _ in (0, 1)]
        want = np.asarray(jtri.fundamental_from_poses(CFG.camera, *(jnp.asarray(x) for x in
                                                                    (Rs[0], ts[0], Rs[1], ts[1]))))
        got = ttri.fundamental_from_poses(TCFG.camera, *(torch.from_numpy(np.array(x)) for x in
                                                         (Rs[0], ts[0], Rs[1], ts[1]))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)


def test_points_match_jax():
    jm, kf1, kf2, n = _far_point_scene()
    tm = convert.map_from_numpy(map_arrays(jm), TCFG, device="cpu")
    jc = jtri.Triangulator(CFG, jm).create_new_points(kf2)
    tc = ttri.Triangulator(TCFG, tm).create_new_points(kf2)
    assert tc >= 0.8 * n and abs(tc - jc) <= 0.05 * jc
    _agree(_created(jm, kf2, n, "pt", jm.pt_pos), _created(tm, kf2, n, "pt", tm.pt_pos))
    # the new landmarks took their descriptors from keyframe 2's features
    arena = tm.point_desc_arena().numpy()
    for f in range(n):
        p = tm.kf_pt_idx[kf2, f]
        if p > 0:
            np.testing.assert_array_equal(arena[p], tm.kf_frames[kf2].kp_desc[f])


def test_pair_step_matches_jax():
    jm, kf1, kf2, n = _far_point_scene()
    args = []
    for kf in (kf2, kf1):
        h = jm.kf_frames[kf]
        cand = h.kp_valid & ~(h.kp_depth > 0) & (jm.kf_pt_idx[kf] < 0)
        args.append((h.kp_xy_un, h.kp_octave, h.kp_desc, cand, jm.kf_R[kf], jm.kf_t[kf]))
    flat = [a for group in args for a in group]
    jpw, jidx, jok = (np.asarray(x) for x in jtri.triangulate_pair_step(
        CFG, *(jnp.asarray(a) for a in flat)))
    tpw, tidx, tok = (x.numpy() for x in ttri.triangulate_pair_step(
        TCFG, *(torch.from_numpy(np.asarray(a)) for a in flat)))
    assert jok.sum() >= 0.8 * n
    both = jok & tok
    assert both.sum() >= 0.95 * max(jok.sum(), tok.sum())
    np.testing.assert_array_equal(tidx[both], jidx[both])
    assert np.abs(tpw[both] - jpw[both]).max() < 1e-3


def test_no_candidates_is_a_noop():
    rng = np.random.default_rng(1)
    fd = _frame_arrays(rng.uniform(0, 600, (10, 2)).astype(np.float32),
                       rng.integers(0, 256, (10, 32), np.uint8))
    fd = fd._replace(kp_depth=np.full(CFG.orb.max_keypoints, 2.0, np.float32))
    jm = JSlamMap(CFG)
    kf = jm.add_keyframe(JHostFrame(fd), np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                         0, 0.0)
    tm = convert.map_from_numpy(map_arrays(jm), TCFG, device="cpu")
    assert ttri.Triangulator(TCFG, tm).create_new_points(kf) == 0
    assert tm.n_points() == 0


def test_lines_match_jax():
    from plslam_tpu.geometry.lines import line_equation_2d
    from plslam_tpu.models.frame import FrameData

    rng = np.random.default_rng(2)
    cam = CFG.camera
    n_ln = 12
    mid = rng.uniform([-1.5, -1, 4.0], [1.5, 1, 7.0], (n_ln, 3))
    d = rng.normal(size=(n_ln, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ep = np.stack([mid - 0.4 * d, mid + 0.4 * d], 1).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    t1, t2 = np.zeros(3, np.float32), np.array([-0.6, 0.05, 0.0], np.float32)
    NL, N = CFG.lines.max_lines, CFG.orb.max_keypoints
    descs = rng.integers(0, 128, (n_ln, 72), np.uint8)

    def frame(t):
        pc = ep @ R.T + t
        uv = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                       cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1).astype(np.float32)
        z = np.zeros
        ln_ep, ln_desc, ln_valid, ln_angle = (z((NL, 2, 2), np.float32), z((NL, 72), np.uint8),
                                              z(NL, bool), z(NL, np.float32))
        ln_ep[:n_ln], ln_desc[:n_ln], ln_valid[:n_ln] = uv, descs, True
        dxy = uv[:, 1] - uv[:, 0]
        ln_angle[:n_ln] = np.arctan2(dxy[:, 1], dxy[:, 0])
        coeff = np.asarray(line_equation_2d(jnp.asarray(ln_ep[:, 0]), jnp.asarray(ln_ep[:, 1])))
        return FrameData(
            kp_xy=z((N, 2), np.float32), kp_xy_un=z((N, 2), np.float32),
            kp_resp=z(N, np.float32), kp_octave=z(N, np.int32), kp_angle=z(N, np.float32),
            kp_desc=z((N, 32), np.uint8), kp_depth=z(N, np.float32), kp_ur=z(N, np.float32),
            kp_valid=z(N, bool), ln_ep=ln_ep, ln_ep_un=ln_ep, ln_angle=ln_angle,
            ln_length=z(NL, np.float32), ln_coeff=coeff.astype(np.float32), ln_desc=ln_desc,
            ln_depth=z((NL, 2), np.float32), ln_valid=ln_valid)

    jm, kf1, kf2 = _two_keyframe_map(frame(t1), frame(t2), R, t1, R, t2,
                                     [(i, i, mid[i % n_ln]) for i in range(25)])
    tm = convert.map_from_numpy(map_arrays(jm), TCFG, device="cpu")
    jc = jtri.create_new_lines(CFG, jm, kf2)
    tc = ttri.create_new_lines(TCFG, tm, kf2)
    assert tc >= 0.6 * n_ln and abs(tc - jc) <= 0.05 * max(jc, 1)
    assert ttri.scene_median_depth(tm, kf1) == jtri.scene_median_depth(jm, kf1)
    a = {f: jm.ln_ep[i] for f in range(n_ln) if (i := jm.kf_ln_idx[kf2, f]) >= 0}
    b = {f: tm.ln_ep[i] for f in range(n_ln) if (i := tm.kf_ln_idx[kf2, f]) >= 0}
    _agree(a, b)
