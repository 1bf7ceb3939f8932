"""plslam_torch local mapping against the JAX package's.

- Distinctive descriptors: the winners equal JAX's exactly, for points
  (Hamming) and lines (flip-invariant LBD distance), first index on ties.
- ``fuse_step`` / ``fuse_multi_step`` on numpy-seeded features and
  landmarks: equal ``idx`` / ``ok``, except for candidates whose window
  test sits within 1e-3 px of the window edge (float32 rounding).
- Landmark culling, keyframe culling and the spanning tree: the map state
  equals JAX's after the same calls (the scenes of tests/test_kf_culling.py
  and tests/test_spanning_tree.py).
- ``LocalMapper.process_keyframe`` on the third keyframe of a JAX-built
  320x240 run (carried by ``plslam_torch.convert``): >= 98% of the valid
  point ids are shared and keyframe poses agree within 1e-3 m. Local BA runs
  on that keyframe; the JAX side solves it in float64 as the port does
  (``torch_parity.jax_ba_in_float64``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import distinctive as jdist
from plslam_tpu.models import local_mapping as jlm
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.map import HostFrame as JHostFrame
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_torch import convert
from plslam_torch.models import distinctive as tdist
from plslam_torch.models import local_mapping as tlm
from test_kf_culling import _build_map, _FakeFrame
from test_spanning_tree import _add_kf
from torch_parity import KW, jax_ba_in_float64, map_arrays, render
from torch_parity import few_torch_threads  # noqa: F401

JCFG = JSlamConfig(camera=JCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
TCFG = convert.config_from_dict(dataclasses.asdict(JCFG))


def _to_torch(m):
    return convert.map_from_numpy(map_arrays(m), TCFG, device="cpu")


def _assert_maps_equal(jm, tm):
    for name in ("kf_valid", "kf_pt_idx", "kf_ln_idx", "kf_parent", "kf_cull_parent",
                 "kf_cull_Rcp", "kf_cull_tcp", "pt_valid", "pt_first_kf", "ln_valid",
                 "ln_first_kf"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert [dict(o) for o in tm.pt_obs] == [dict(o) for o in jm.pt_obs]
    assert [set(c) for c in tm.kf_children] == [set(c) for c in jm.kf_children]


# --------------------------------------------------------- distinctive
@pytest.mark.parametrize("kind", ["points", "lines"])
def test_distinctive_winners_equal_jax(kind):
    rng = np.random.default_rng(7)
    K, N, P, O = 6, 40, 64, jdist.MAX_OBS
    width, hi = (32, 256) if kind == "points" else (72, 128)
    stacked = rng.integers(0, hi, (K, N, width), dtype=np.uint8)
    stacked[1, :10] = stacked[0, :10]  # exact duplicates: ties in the median
    slot = rng.integers(0, K, (P, O))
    feat = rng.integers(0, N, (P, O))
    feat[:8] = np.arange(10)[:, None][:8] % 10
    slot[:8] = np.arange(O) % 2
    valid = rng.random((P, O)) < 0.7
    valid[:, 0] = True
    valid[5] = False
    jfn = jdist._distinctive_core if kind == "points" else jdist._line_distinctive_core
    tfn = tdist._distinctive_core if kind == "points" else tdist._line_distinctive_core
    want = np.asarray(jfn(jnp.asarray(stacked), jnp.asarray(slot, jnp.int32),
                          jnp.asarray(feat, jnp.int32), jnp.asarray(valid)))
    got = tfn(torch.from_numpy(stacked), torch.from_numpy(slot), torch.from_numpy(feat),
              torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_refresh_distinctive_on_a_map_equals_jax():
    jm, pids = _build_map(JCFG, n_kf=4, n_pts=30)
    rng = np.random.default_rng(3)
    for k in range(4):
        jm.kf_frames[k].kp_desc[:] = rng.integers(0, 256, jm.kf_frames[k].kp_desc.shape,
                                                  dtype=np.uint8)
    tm = _to_torch(jm)
    assert jdist.refresh_distinctive_descriptors(jm, pids) == len(pids)
    assert tdist.refresh_distinctive_descriptors(tm, pids) == len(pids)
    np.testing.assert_array_equal(tm.point_desc_arena().numpy(),
                                  np.asarray(jm.point_desc_arena()))


# --------------------------------------------------------------- fusion
def _fuse_inputs(rng, B=None):
    lead = () if B is None else (B,)
    N, C = 300, 400
    kxy = rng.uniform([0, 0], [640, 480], lead + (N, 2)).astype(np.float32)
    koct = rng.integers(0, 8, lead + (N,)).astype(np.int32)
    kdesc = rng.integers(0, 256, lead + (N, 32), dtype=np.uint8)
    kval = rng.random(lead + (N,)) < 0.9
    if B is not None:  # every keyframe sees the same features, a little moved
        kxy[1:] = kxy[0] + rng.normal(0, 1.0, (B - 1, N, 2)).astype(np.float32)
        koct[1:] = koct[0]
        kdesc[1:] = kdesc[0]
    # candidates near features of the first keyframe, at depth 2-4 m
    src = rng.integers(0, N, C)
    first = kxy if B is None else kxy[0]
    uv = first[src] + rng.normal(0, 2.0, (C, 2))
    z = rng.uniform(2, 4, C)
    cam = JCFG.camera
    p3d = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z],
                   -1).astype(np.float32)
    desc = (kdesc if B is None else kdesc[0])[src].copy()
    flip = rng.random((C, 32)) < 0.03
    desc[flip] ^= 0x11
    dist = np.linalg.norm(p3d, axis=-1)
    # predicted level: the source feature's octave + 1 (half a level from
    # the ceil's boundary)
    maxd = (dist * 1.2 ** ((koct if B is None else koct[0])[src] + 0.5)).astype(np.float32)
    mind = (maxd / 1.2**7).astype(np.float32)
    valid = rng.random(C) < 0.95
    if B is None:
        R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    else:
        R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
        t = (rng.normal(0, 0.01, (B, 3)) * (np.arange(B) > 0)[:, None]).astype(np.float32)
    return (kxy, koct, kdesc, kval, p3d, desc, mind, maxd, valid, R, t)


def _window_margin(args, radius_px, b=None):
    """Per candidate, the smallest |r - |du||, |r - |dv|| over the features,
    in float64 (how close its window test is to flipping)."""
    kxy, koct, _, _, p3d, _, _, maxd, _, R, t = args
    if b is not None:
        kxy, R, t = kxy[b], R[b], t[b]
    cam = JCFG.camera
    pc = p3d.astype(np.float64) @ R.T + t
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    dist = np.linalg.norm(p3d - (-R.T @ t), axis=-1)
    pred = np.clip(np.ceil(np.log(maxd / dist) / np.log(1.2)), 0, 7)
    r = radius_px * 1.2**pred
    d = np.abs(uv[:, None, :] - kxy[None].astype(np.float64))
    return np.abs(r[:, None, None] - d).min(axis=(1, 2))


def _check_fuse(j, t, margin):
    jidx, jok = (np.asarray(x) for x in j)
    tidx, tok = (x.numpy() for x in t)
    diff = (jok != tok) | (jok & (jidx != tidx))
    assert jok.sum() > 50
    assert (margin[diff] < 1e-3).all(), margin[diff]


def test_fuse_step_matches_jax():
    args = _fuse_inputs(np.random.default_rng(0))
    j = jlm.fuse_step(JCFG, *(jnp.asarray(a) for a in args))
    t = tlm.fuse_step(TCFG, *(torch.from_numpy(np.array(a)) for a in args))
    _check_fuse(j, t, _window_margin(args, tlm.FUSE_TH_PX))


def test_fuse_multi_step_matches_jax():
    B = 4
    args = _fuse_inputs(np.random.default_rng(1), B)
    j = jlm.fuse_multi_step(JCFG, *(jnp.asarray(a) for a in args), radius_px=5.0)
    t = tlm.fuse_multi_step(TCFG, *(torch.from_numpy(np.array(a)) for a in args),
                            radius_px=5.0)
    assert t[0].shape == (B, args[4].shape[0])
    for b in range(B):
        _check_fuse((j[0][b], j[1][b]), (t[0][b], t[1][b]), _window_margin(args, 5.0, b))


# ------------------------------------------------------------- culling
@pytest.mark.parametrize("scene", ["redundant", "unique_view", "far_points"])
def test_keyframe_culling_equals_jax(scene):
    if scene == "far_points":
        jm = JSlamMap(JCFG)
        far = JCFG.tracking.th_depth * 2
        for k in range(5):
            jm.add_keyframe(JHostFrame(_FakeFrame(JCFG.orb.max_keypoints,
                                                     JCFG.lines.max_lines, depth=far)),
                            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), k, k)
        for i in range(40):
            pid = jm.add_point(np.array([i * 0.05, 0, far]), np.zeros(32, np.uint8),
                               np.array([0, 0, 1.0]), 0.5, 50.0, 0)
            for k in range(5):
                jm.add_point_obs(pid, k, i)
        cur = 4
    else:
        jm, pids = _build_map(JCFG, n_kf=5 if scene == "redundant" else 3)
        cur = 4 if scene == "redundant" else 2
        if scene == "unique_view":
            for pid in pids[:30]:
                for k in (0, 2):
                    feat = jm.pt_obs[pid].pop(k)
                    jm.kf_pt_idx[k, feat] = -1
    for k in range(1, jm.n_kf):
        jm.update_spanning_tree(k)
    tm = _to_torch(jm)
    jlm.LocalMapper(JCFG, jm, enable_ba=False).cull_keyframes(cur)
    tlm.LocalMapper(TCFG, tm).cull_keyframes(cur)
    _assert_maps_equal(jm, tm)
    if scene == "redundant":
        assert not tm.kf_valid[1:4].all() and tm.kf_valid[0] and tm.kf_valid[4]
    else:
        assert tm.kf_valid[:jm.n_kf].all()


def test_landmark_culling_equals_jax():
    jm, pids = _build_map(JCFG, n_kf=3, n_pts=40)
    rng = np.random.default_rng(5)
    jm.pt_visible[pids] = rng.integers(1, 10, len(pids))
    jm.pt_found[pids] = rng.integers(0, 4, len(pids))
    for pid in pids[::3]:  # one observation left
        for k in (1, 2):
            jm.kf_pt_idx[k, jm.pt_obs[pid].pop(k)] = -1
    tm = _to_torch(jm)
    recent = [(p, int(rng.integers(0, 3))) for p in pids]
    jmap, tmap = jlm.LocalMapper(JCFG, jm), tlm.LocalMapper(TCFG, tm)
    jmap.recent_points, tmap.recent_points = list(recent), list(recent)
    jmap.cull_points(3)
    tmap.cull_points(3)
    assert tmap.recent_points == jmap.recent_points
    assert 0 < tm.n_points() < len(pids)
    _assert_maps_equal(jm, tm)


def test_spanning_tree_equals_jax():
    jm = JSlamMap(JCFG)
    for k in range(5):
        _add_kf(jm, JCFG, k)
    rng = np.random.default_rng(9)
    for i in range(40):
        pid = jm.add_point([0, 0, 1], np.zeros(32, np.uint8), [0, 0, 1], 0.1, 10.0, 0)
        for kf in rng.choice(5, size=int(rng.integers(2, 5)), replace=False):
            jm.add_point_obs(pid, int(kf), i)
    tm = _to_torch(jm)
    for m in (jm, tm):
        for k in range(5):
            m.update_spanning_tree(k)
    _assert_maps_equal(jm, tm)
    for kf in (2, 1):
        jm.erase_keyframe(kf)
        tm.erase_keyframe(kf)
        _assert_maps_equal(jm, tm)
    assert tm.kf_parent[0] == -1 and not tm.kf_valid[1] and not tm.kf_valid[2]


# ------------------------------------------------- process_keyframe
@pytest.fixture(scope="module")
def before_third_keyframe():
    """The JAX map and the mapper's recent-landmark lists just before
    ``process_keyframe`` of keyframe 2, and the JAX map after it."""
    jcfg = JSlamConfig(camera=JCamera(**KW))
    jm = JSlamMap(jcfg)
    mapper = jlm.LocalMapper(jcfg, jm)
    snap = {}
    orig = mapper.process_keyframe

    def process_keyframe(kf):
        if kf == 2:
            snap.update(arrays=map_arrays(jm), recent=(list(mapper.recent_points),
                                                       list(mapper.recent_lines)))
        orig(kf)
        if kf == 2:
            snap.update(after=map_arrays(jm))

    mapper.process_keyframe = process_keyframe
    tracker = jtracking.Tracker(jcfg, jm, local_mapper=mapper)
    with jax_ba_in_float64():
        for i, (g, d) in enumerate(render(12, total=100)):
            tracker.process(g, d, i / 30.0)
            if "after" in snap:
                break
    assert "after" in snap, jm.n_kf
    return jcfg, snap


def test_process_keyframe_matches_jax(before_third_keyframe):
    jcfg, snap = before_third_keyframe
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tm = convert.map_from_numpy(snap["arrays"], cfg, device="cpu")
    mapper = tlm.LocalMapper(cfg, tm)
    mapper.recent_points, mapper.recent_lines = (list(r) for r in snap["recent"])
    from plslam_torch.optim import local_ba

    runs = local_ba.bundle_adjust_stepped.runs
    mapper.process_keyframe(2)
    assert local_ba.bundle_adjust_stepped.runs == runs + 1
    assert mapper.fuse_passes == 1
    after = snap["after"]
    jp = set(np.nonzero(after["pt_valid"])[0])
    tp = set(tm.point_ids())
    assert len(jp & tp) >= 0.98 * max(len(jp), len(tp))
    for k in range(tm.n_kf):
        assert tm.kf_valid[k] == after["kf_valid"][k]
        c = -tm.kf_R[k].T @ tm.kf_t[k]
        jc = -after["kf_R"][k].T @ after["kf_t"][k]
        assert np.linalg.norm(c - jc) < 1e-3
    # BA moved the new keyframe; fusion, culling and BA changed the
    # observations alike
    assert np.abs(tm.kf_t[2] - snap["arrays"]["kf_t"][2]).max() > 0
    n_obs = sum(len(o) for o in tm.pt_obs)
    assert abs(n_obs - sum(len(o) for o in after["pt_obs"])) <= 0.02 * n_obs
    assert n_obs != sum(len(o) for o in snap["arrays"]["pt_obs"])
