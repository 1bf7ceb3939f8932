"""The port's loop-closing path end to end on the CPU (slow tier).

- The severed-map loop of tests/test_loop_closing.py::run_severed_loop_check
  (640x480, RoomScene(3), the 150-frame orbit, culling off, points only as
  that test runs): track the orbit through a synchronous LocalMapper and
  LoopCloser, sever and displace the old half of the map, submit the newest
  keyframe up to 3 times; the loop must close across the cut with >= 20
  cross-sector landmarks and the anchor error against ground truth must go
  from > 5 cm to < 5 cm and < 0.3x.
- The asynchronous variant of tests/test_async_loop.py (points and lines,
  AsyncLocalMapper + AsyncLoopCloser): the same severed state, the
  keyframe submitted while orbit frames 120-149 keep being fed back and
  forth (no 87-degree jump from frame 149 to 120). Asserted on the
  order of events (the worker's pass starts, frames retire, the loop
  closes) rather than on wall-clock races, and on the final KF0-relative
  error < 30 cm.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from plslam_torch.bow.database import KeyFrameDatabase
from plslam_torch.bow.vocabulary import Vocabulary
from plslam_torch.config import SlamConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.models.async_mapping import AsyncLocalMapper, AsyncLoopCloser
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.loop_closing import LoopCloser
from plslam_torch.models.map import SlamMap
from plslam_torch.models.tracking import Tracker
from plslam_torch.utils.synthetic import RoomScene
from torch_loop_scenario import W_R, W_t, anchor_err, kf0_relative_err, orbit_poses, \
    render_orbit, revisit_order, sever_and_displace, walk_to

pytestmark = pytest.mark.slow

CAM = Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)


@pytest.fixture(autouse=True, scope="module")
def four_torch_threads():
    """A fixed intra-op thread count: the float reductions, and with them
    the map and the loop pair the closer picks, depend on it (ROADMAP
    Queue C)."""
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _system(use_lines, asynchronous):
    cfg = SlamConfig(camera=CAM, use_lines=use_lines)
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, kf_culling_redundancy=10.0))
    voc = Vocabulary.load(device="cpu")
    m = SlamMap(cfg, device="cpu")
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    lm = LocalMapper(cfg, m, kfdb=kfdb)
    if asynchronous:
        lm = AsyncLocalMapper(lm)
    lc = LoopCloser(cfg, m, kfdb, voc, local_mapper=lm)
    if asynchronous:
        lc = AsyncLoopCloser(lc)
    tr = Tracker(cfg, m, local_mapper=lm, loop_closer=lc, voc=voc, kfdb=kfdb)
    lc.tracker = tr
    return cfg, m, lm, lc, tr


def _sever(m, tr, lc):
    kf_cut = max(m.n_kf // 2, 1)
    sever_and_displace(m, kf_cut, W_R, W_t)
    base = getattr(lc, "inner", lc)
    base.prev_groups = []
    base.last_loop_kf = -(10**9)
    base.n_loops_closed = 0
    base.last_loop_pair = None
    return kf_cut


def _check_anchor(m, lc, kf_cut, disp_R, disp_t, poses, frame_of=None):
    """``disp_R`` / ``disp_t``: the keyframe poses before the correction;
    ``frame_of`` maps a tracker frame id to its orbit frame where they
    differ (frames fed again during the worker's pass)."""
    assert lc.n_loops_closed >= 1, "loop closure never fired"
    k1, k2 = lc.last_loop_pair
    assert k2 < kf_cut <= k1, (k1, k2, kf_cut)
    cross = sum(1 for pid in m.point_ids()
                if any(q < kf_cut for q in m.pt_obs[pid])
                and any(q >= kf_cut for q in m.pt_obs[pid]))
    assert cross >= 20, f"only {cross} cross-sector landmarks"
    K = len(disp_R)
    gt = [poses[(frame_of or {}).get(int(f), int(f))] for f in m.kf_frame_id[:K]]
    gt_R = np.stack([R for R, _ in gt])
    gt_t = np.stack([t for _, t in gt])
    before = anchor_err(disp_R, disp_t, k2, k1, gt_R, gt_t)
    after = anchor_err(m.kf_R, m.kf_t, k2, k1, gt_R, gt_t)
    assert before > 0.05, before
    assert after < 0.05 and after < 0.3 * before, (before, after)


def test_severed_loop_closes_in_the_port():
    cfg, m, lm, lc, tr = _system(use_lines=False, asynchronous=False)
    poses = orbit_poses(150)
    frames = render_orbit(RoomScene(3), CAM, poses, cfg.tracking.depth_map_factor)
    for i, (g, d) in enumerate(frames):
        tr.process(g, d, i / 30.0)
    tr.flush()
    kf_cut = _sever(m, tr, lc)
    disp_R, disp_t = m.kf_R[:m.n_kf].copy(), m.kf_t[:m.n_kf].copy()
    k = max(q for q in range(m.n_kf) if m.kf_valid[q])
    for _ in range(3):
        lc.process_keyframe(k)
        if lc.n_loops_closed:
            break
    _check_anchor(m, lc, kf_cut, disp_R, disp_t, poses)


def test_async_loop_closes_while_frames_retire():
    cfg, m, lm, lc, tr = _system(use_lines=True, asynchronous=True)
    poses = orbit_poses(150)
    frames = render_orbit(RoomScene(3), CAM, poses, cfg.tracking.depth_map_factor)
    events = []
    ev_lock = threading.Lock()

    def note(what):
        with ev_lock:
            events.append(what)

    inner = lc.inner
    orig_process = inner.process_keyframe
    orig_propagate = inner._propagate_group
    pre = []  # keyframe poses just before the correction (the loop may close
    # on a keyframe the tracker made during the pass)

    def process_keyframe(kf):
        note("pass started")
        before = inner.n_loops_closed
        orig_process(kf)
        if inner.n_loops_closed > before:
            note("loop closed")

    def propagate_group(*a):
        if not pre:  # the caller holds the map lock
            pre.append((m.kf_R[:m.n_kf].copy(), m.kf_t[:m.n_kf].copy()))
        orig_propagate(*a)

    try:
        for i, (g, d) in enumerate(frames):
            tr.process(g, d, i / 30.0)
        tr.flush()
        for w in (lm, lc, lm):
            assert w.wait_idle(timeout=600.0)
        with tr._map_lock:
            kf_cut = _sever(m, tr, lc)
        tr._refresh_local_map(tr.last_pt_ids, tr.last_ln_ids)
        k = max(q for q in range(m.n_kf) if m.kf_valid[q])
        inner.process_keyframe = process_keyframe
        inner._propagate_group = propagate_group
        n, j = len(frames), 0
        order, cur = revisit_order(), n - 1
        frame_of = {}
        for _ in range(3):
            lc.process_keyframe(k)
            while not lc.idle and j < 120:
                cur = next(order)
                if tr.process(*frames[cur], (n + j) / 30.0) is not None:
                    note("retired")
                frame_of[tr.frame_id] = cur
                j += 1
            if lc.n_loops_closed:
                break
        for w in (lm, lc, lm):
            assert w.wait_idle(timeout=600.0)
        assert lc.error is None and lm.error is None, (lc.error, lm.error)
        _check_anchor(m, lc, kf_cut, *pre[0], poses, frame_of)
        closed = events.index("loop closed")
        first_pass = events.index("pass started")
        assert "retired" in events[first_pass:closed], events
        for i in walk_to(cur, 139) + list(range(140, 150)):
            tr.process(*frames[i], (n + j) / 30.0)
            j += 1
        tr.flush()
        assert kf0_relative_err(m, tr.last_pose, poses) < 0.30
    finally:
        lc.shutdown()
        lm.shutdown()
