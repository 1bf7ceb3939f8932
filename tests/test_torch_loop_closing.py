"""plslam_torch.models.loop_closing against the JAX package's, on one map.

The JAX package tracks a short out-and-back leg of the orbit of
tests/test_loop_closing.py at 320x240 (points only, culling off, a
synchronous LocalMapper, so the leg's end revisits its start), the map is
severed and displaced with tests/test_loop_closing.py::sever_and_displace,
and map and keyframe database are carried to the port with
``plslam_torch.convert``. Then, each package on its own copy:

- ``_build_essential_problem``: every array equal (numpy on equal inputs),
  with loop connections and an earlier loop edge, at scale 1 and 1.3;
- ``_propagate_group``, and the essential graph's write-back
  (``set_kf_pose``, ``_transport_landmarks``, ``_correct_appended_kfs``):
  poses and landmarks within 1e-5 m;
- ``_detect_loop`` three times on the newest keyframe: the same candidates
  and consistency groups each time, from the database carried with
  ``kfdb_from_numpy``;
- ``_compute_relative`` against the old keyframes with the RANSAC draws
  the JAX package makes injected: the same accept / reject, R12 / t12
  within 1e-3; and, port-only, the same result when the map moves while
  the solve runs outside the lock (it reads a snapshot);
- the SearchBySim3 matcher's B = 2 combination equals the plain top-1 of
  the elementwise minimum, ties included.

And port-only: the tracker's gauge-correction protocol (a copy of
tests/test_async_loop.py::test_gauge_delta_composes_pipelined_frames at
320x240), and the worker wrappers' interface.
"""

import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax

from plslam_tpu.bow.database import KeyFrameDatabase as JKeyFrameDatabase
from plslam_tpu.bow.vocabulary import Vocabulary as JVocabulary
from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plslam_tpu.models.loop_closing import LoopCloser as JLoopCloser
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_tpu.optim import horn as jhorn
from plslam_tpu.optim import pose_graph as jpose_graph
from plslam_tpu.utils.synthetic import RoomScene
from plslam_torch import convert
from plslam_torch.models import tracking as ttracking
from plslam_torch.models.async_mapping import AsyncLocalMapper, AsyncLoopCloser
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.loop_closing import LoopCloser
from plslam_torch.models.map import SlamMap
from plslam_torch.ops import hamming, matching
from test_loop_closing import sever_and_displace as jax_sever_and_displace
from test_torch_bow import VOCABS
from torch_loop_scenario import W_R, W_t, orbit_poses, render_orbit
from torch_parity import KW, map_arrays
from torch_parity import few_torch_threads  # noqa: F401

# out to orbit pose LEG - STEP and back to pose 0, a pose every STEP
LEG, STEP = 48, 2
POSE_TOL = 1e-5


def leg_poses():
    poses = orbit_poses(150)
    idx = list(range(0, LEG, STEP)) + list(range(LEG - STEP, -1, -STEP))
    return [poses[i] for i in idx]


@pytest.fixture(scope="module")
def jax_severed():
    """The JAX package's map of the leg, severed and displaced; its config,
    vocabulary, database and the cut."""
    jcfg = JSlamConfig(camera=JCamera(**KW), use_lines=False)
    jcfg = jcfg.replace(mapping=dataclasses.replace(jcfg.mapping, kf_culling_redundancy=10.0))
    voc = JVocabulary.load(VOCABS["synth"])
    jm = JSlamMap(jcfg)
    jdb = JKeyFrameDatabase(voc, max_kf=jcfg.capacity.max_keyframes)
    jtr = jtracking.Tracker(jcfg, jm, local_mapper=JLocalMapper(jcfg, jm, kfdb=jdb), voc=voc,
                            kfdb=jdb)
    for i, (g, d) in enumerate(render_orbit(RoomScene(3), jcfg.camera, leg_poses(), 5000.0)):
        jtr.process(g, d, i / 30.0)
    jtr.flush()
    assert jtr.state == jtracking.OK and jm.n_kf >= 10
    kf_cut = jm.n_kf // 2
    jax_sever_and_displace(jm, jtr, kf_cut, W_R, W_t)
    jm.loop_edges = [(0, kf_cut)]  # an earlier loop, re-asserted by the graph
    return jcfg, jm, jdb, voc, kf_cut


@pytest.fixture(scope="module")
def port_parts(jax_severed):
    """The port's config, vocabulary and database, carried across."""
    jcfg, jm, jdb, voc, _ = jax_severed
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tvoc = convert.vocabulary_from_numpy([np.asarray(d) for d in voc.node_desc],
                                         np.asarray(voc.idf), device="cpu")
    kfdb = convert.kfdb_from_numpy(tvoc, [jdb.get_bow(k) for k in range(jdb.max_kf)], jdb.max_kf)
    return cfg, tvoc, kfdb


def _jax_copy(jm):
    """A JAX map whose host arrays and observation dicts are copies.

    The source's descriptor rows staged on the host are flushed into its
    device arenas first, and the copy gets dirty-row lists of its own: a
    shallow copy would share them, so the first arena read of any copy (or
    ``map_arrays`` of the source) would flush the shared list into that map
    alone and leave every later copy with a stale arena."""
    jm.point_desc_arena()
    jm.line_desc_arena()
    c = copy.copy(jm)
    c._pt_desc_dirty = []
    c._ln_desc_dirty = []
    for name in convert._ARRAYS:
        setattr(c, name, np.array(getattr(jm, name)))
    c.pt_obs = [dict(o) for o in jm.pt_obs]
    c.ln_obs = [dict(o) for o in jm.ln_obs]
    c.kf_children = [set(s) for s in jm.kf_children]
    c.loop_edges = list(jm.loop_edges)
    return c


def _closers(jax_severed, port_parts):
    """(JAX LoopCloser, port LoopCloser), each on its own copy of the map."""
    jcfg, jm, jdb, voc, _ = jax_severed
    cfg, tvoc, kfdb = port_parts
    jlc = JLoopCloser(jcfg, _jax_copy(jm), jdb, voc)
    tlc = LoopCloser(cfg, convert.map_from_numpy(map_arrays(jm), cfg, device="cpu"), kfdb, tvoc)
    return jlc, tlc


def _newest(m):
    return max(k for k in range(m.n_kf) if m.kf_valid[k])


def _assert_map_close(jm, tm, tol=POSE_TOL):
    K = jm.n_kf
    np.testing.assert_allclose(tm.kf_R[:K], jm.kf_R[:K], atol=tol)
    np.testing.assert_allclose(tm.kf_t[:K], jm.kf_t[:K], atol=tol)
    pids = jm.point_ids()
    np.testing.assert_array_equal(tm.point_ids(), pids)
    np.testing.assert_allclose(tm.pt_pos[pids], jm.pt_pos[pids], atol=tol)
    lids = jm.line_ids()
    np.testing.assert_allclose(tm.ln_ep[lids], jm.ln_ep[lids], atol=tol)


@pytest.mark.parametrize("group_scale", [1.0, 1.3])
def test_build_essential_problem_equal(jax_severed, port_parts, group_scale):
    jlc, tlc = _closers(jax_severed, port_parts)
    jm = jlc.map
    kf_cut = jax_severed[4]
    kf1, kf2 = _newest(jm), 1
    K = jm.n_kf
    group = {kf1} | set(jm.covisible_keyframes(kf1))
    R_before, t_before = jm.kf_R[:K].copy(), jm.kf_t[:K].copy()
    conns = [(kf2, kf1), (0, kf_cut + 1)]
    jprob, js_node, js_meas = jlc._build_essential_problem(
        jpose_graph, kf1, kf2, K, R_before, t_before, conns, group=group,
        group_scale=group_scale)
    tprob, ts_node, ts_meas = tlc._build_essential_problem(
        kf1, kf2, K, R_before, t_before, conns, group=group, group_scale=group_scale)
    assert int(np.asarray(jprob.e_valid).sum()) > K  # tree, covisibility and loop edges
    for name in jprob._fields:
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
    np.testing.assert_array_equal(ts_node, js_node)
    np.testing.assert_array_equal(ts_meas, js_meas)


@pytest.mark.parametrize("s", [1.0, 1.3])
def test_propagate_group_equal(jax_severed, port_parts, s):
    jlc, tlc = _closers(jax_severed, port_parts)
    jm, tm = jlc.map, tlc.map
    kf1, kf2 = _newest(jm), 1
    group = [kf1] + jm.covisible_keyframes(kf1)
    assert len(group) >= 2
    R1_old, t1_old = jm.kf_R[kf1].copy(), jm.kf_t[kf1].copy()
    # the correction a loop against kf2 would make: T_1w = T_12 ∘ T_2w
    R12 = jm.kf_R[kf1] @ W_R @ jm.kf_R[kf2].T
    t12 = np.array([0.02, -0.01, 0.03], np.float32)
    R1_corr = (R12 @ jm.kf_R[kf2]).astype(np.float32)
    t1_corr = (s * (R12 @ jm.kf_t[kf2]) + t12).astype(np.float32)
    jlc._propagate_group(group, R1_old, t1_old, R1_corr, t1_corr, s)
    tlc._propagate_group(group, R1_old, t1_old, R1_corr, t1_corr, s)
    assert np.abs(jm.kf_t[kf1] - t1_old).max() > 0.01  # the group moved
    _assert_map_close(jm, tm)


@pytest.mark.parametrize("mono", [False, True])
def test_graph_write_back_equal(jax_severed, port_parts, mono):
    """The essential graph's write-back of _optimize_essential_graph on
    given solver outputs: poses set (scale folded), landmarks transported
    with their reference keyframe, and the two newest keyframes treated as
    appended while the solve ran, re-expressed against their anchors."""
    jlc, tlc = _closers(jax_severed, port_parts)
    jm, tm = jlc.map, tlc.map
    K = jm.n_kf - 2
    rng = np.random.default_rng(4)
    xi = rng.normal(0, 1, (K, 6)).astype(np.float32) * np.array([0.01] * 3 + [0.03] * 3,
                                                               np.float32)
    from plslam_torch.geometry import se3 as tse3

    Rn, tn = (x.numpy() for x in tse3.left_update(torch.from_numpy(xi),
                                                 torch.from_numpy(jm.kf_R[:K]),
                                                 torch.from_numpy(jm.kf_t[:K])))
    sn = (rng.uniform(0.9, 1.1, K) if mono else np.ones(K)).astype(np.float32)
    s_old = np.full(K, 1.2, np.float32) if mono else None
    for lc in (jlc, tlc):
        m = lc.map
        old_R, old_t = m.kf_R[:K].copy(), m.kf_t[:K].copy()
        for k in range(K):
            if m.kf_valid[k]:
                m.set_kf_pose(k, Rn[k], tn[k] / sn[k])
        lc._transport_landmarks(K, old_R, old_t, Rn, tn, sn, s_old=s_old)
        lc._correct_appended_kfs(K, old_R, old_t)
    assert np.abs(jm.kf_t[K:jm.n_kf] - jax_severed[1].kf_t[K:jm.n_kf]).max() > 1e-3
    _assert_map_close(jm, tm)


def test_detect_loop_same_candidates(jax_severed, port_parts):
    jlc, tlc = _closers(jax_severed, port_parts)
    k = _newest(jlc.map)
    seen = []
    for _ in range(3):
        jc = jlc._detect_loop(k)
        tc = tlc._detect_loop(k)
        assert tc == jc
        assert [(g, c) for g, c in tlc.prev_groups] == [(g, c) for g, c in jlc.prev_groups]
        seen.append(jc)
    assert seen[-1], "no consistent candidate after 3 submissions"


def _jax_draws(monkeypatch):
    """Records the index sets the JAX package's ransac_align draws from the
    keys the loop closer passes it."""
    draws = []
    orig = jhorn.ransac_align

    def recording(src, dst, valid, key, **kw):
        pool = max(int(np.asarray(valid).sum()), 3)
        draws.append(np.asarray(jax.random.randint(key, (kw.get("n_hyp", 256), 3), 0, pool)))
        return orig(src, dst, valid, key, **kw)

    monkeypatch.setattr(jhorn, "ransac_align", recording)
    return draws


def test_compute_relative_with_jax_draws(jax_severed, port_parts, monkeypatch):
    jlc, tlc = _closers(jax_severed, port_parts)
    kf_cut = jax_severed[4]
    k1 = _newest(jlc.map)
    draws = _jax_draws(monkeypatch)
    outcomes = []
    for k2 in range(min(kf_cut, 4)):
        draws.clear()
        jout = jlc._compute_relative(k1, k2)
        samples = [torch.from_numpy(d.copy()) for d in draws] + [None] * (3 - len(draws))
        tout = tlc._compute_relative(k1, k2, horn_samples=samples)
        assert (jout is None) == (tout is None), (k2, jout, tout)
        outcomes.append(jout is not None)
        if jout is not None:
            jR, jt, js, jn = jout
            tR, tt, ts, tn = tout
            assert tn == jn
            np.testing.assert_allclose(tR, np.asarray(jR), atol=1e-3)
            np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-3)
            assert abs(ts - js) < 1e-3
    assert any(outcomes) and not all(outcomes), outcomes  # both verdicts were compared


class _TearingLock:
    """The closer's map lock, wrapped: the first release moves every map
    point and kf2's translation by 0.5 m (a local BA write-back landing while
    the solve runs unlocked), the next acquire puts them back, so the locked
    sections see the map as it was."""

    def __init__(self, lock, m, kf2):
        self.lock, self.m, self.kf2 = lock, m, kf2
        self.releases = 0
        self.saved = None

    def __enter__(self):
        self.lock.__enter__()
        if self.saved is not None:
            self.m.pt_pos[:], self.m.kf_t[self.kf2] = self.saved
            self.saved = None
        return self

    def __exit__(self, *exc):
        self.releases += 1
        if self.releases == 1:
            self.saved = (self.m.pt_pos.copy(), self.m.kf_t[self.kf2].copy())
            self.m.pt_pos += 0.5
            self.m.kf_t[self.kf2] += 0.5
        return self.lock.__exit__(*exc)


def test_compute_relative_reads_a_snapshot(jax_severed, port_parts, monkeypatch):
    """The relative-pose solve runs outside the map lock; what it reads of
    the map (landmark positions, both keyframes' poses) is copied under the
    lock, so a write-back landing mid-solve leaves its result unchanged."""
    jlc, tlc = _closers(jax_severed, port_parts)
    k1 = _newest(jlc.map)
    draws = _jax_draws(monkeypatch)
    for k2 in range(min(jax_severed[4], 4)):
        draws.clear()
        if jlc._compute_relative(k1, k2) is not None:
            break
    else:
        pytest.fail("no accepted loop pair")
    samples = [torch.from_numpy(d.copy()) for d in draws] + [None] * (3 - len(draws))
    want = tlc._compute_relative(k1, k2, horn_samples=samples)
    assert want is not None
    tear = _TearingLock(tlc.lock, tlc.map, k2)
    tlc.lock = tear
    got = tlc._compute_relative(k1, k2, horn_samples=samples)
    assert tear.releases == 2 and tear.saved is None
    assert got is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


def test_min_of_two_is_the_top1_of_the_minimum():
    """The SearchBySim3 matcher: one batched call over (features, landmark
    descriptors), combined, equals best_matches over the elementwise
    minimum of the two distance matrices (the JAX package's formulation),
    with ties across the two rows and within one, and gated-out rows."""
    rng = np.random.default_rng(11)
    n = m = 300
    q = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    t = torch.as_tensor(rng.integers(0, 256, (2, m, 32), dtype=np.uint8))
    t[0, 100:140] = q[:40]
    t[1, 150:190] = q[:40]     # a tie across the rows: the lower index wins
    t[1, 200:220] = q[40:60]
    t[1, 230:250] = q[40:60]   # a tie within the landmark row
    t[0, 260:270] = q[60:70] ^ 1
    t[1, 260:270] = q[60:70]   # the landmark row is closer
    gate = torch.as_tensor(rng.random((n, m)) < 0.3)
    gate[:70, 100:270] = True
    gate[75] = False
    for dedupe in (False, True):
        got = matching.match_min_of_two(q, t, gate, 50, dedupe=dedupe)
        dmin = torch.minimum(hamming.hamming_matrix(q, t[0]), hamming.hamming_matrix(q, t[1]))
        want = matching.best_matches(dmin, gate, 50)
        if dedupe:
            want = matching.dedupe_targets(want, m)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    idx = got.idx.numpy()
    assert (idx[:40] == np.arange(100, 140)).all()
    assert (idx[40:60] == np.arange(200, 220)).all()
    assert (idx[60:70] == np.arange(260, 270)).all() and (got.dist.numpy()[60:70] == 0).all()
    assert idx[75] == -1


# ---------------------------------------------------------------- gauge
def test_gauge_delta_composes_pipelined_frames():
    """tests/test_async_loop.py's test at 320x240 in the port: a correction
    published mid-run moves the device pose state, frames dispatched before
    it retire in the new gauge, and the healed trajectory is continuous."""
    cfg = convert.config_from_dict(dataclasses.asdict(JSlamConfig(camera=JCamera(**KW))))
    m = SlamMap(cfg, device="cpu")
    tr = ttracking.Tracker(cfg, m, local_mapper=LocalMapper(cfg, m))
    # 32 frames: at 320x240 the tracker's own steps stay within the bar
    # below up to there (past frame 33 a few reach 10-17 cm, correction or not)
    poses = orbit_poses(150)[:32]
    c, s_ = np.cos(0.05), np.sin(0.05)
    delta_R = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
    delta_t = np.array([0.1, -0.05, 0.2], np.float32)
    for i, (g, d) in enumerate(render_orbit(RoomScene(3), cfg.camera, poses, 5000.0)):
        tr.process(g, d, i / 30.0)
        if i == 22:
            for k in range(m.n_kf):
                if m.kf_valid[k]:
                    Rk, tk = m.kf_R[k], m.kf_t[k]
                    m.set_kf_pose(k, Rk @ delta_R, Rk @ delta_t + tk)
            pids = m.point_ids()
            m.pt_pos[pids] = (m.pt_pos[pids] - delta_t) @ delta_R
            lids = m.line_ids()
            for j in (0, 1):
                m.ln_ep[lids, j] = (m.ln_ep[lids, j] - delta_t) @ delta_R
            tr.apply_gauge_correction(delta_R, delta_t)
            assert tr._pending_gauge is not None
    tr.flush()
    assert tr._pending_gauge is None and tr._corr_epoch == 1
    assert len(tr.trajectory) >= 28
    gt_centers = np.array([-(R.T @ t) for R, t in poses])
    gt_step_max = np.linalg.norm(np.diff(gt_centers, axis=0), axis=1).max()
    raw = np.array([-(R.T @ t) for _, R, t in tr.trajectory])
    assert np.linalg.norm(np.diff(raw, axis=0), axis=1).max() > 0.15, "no raw gauge jump"
    heal = tr.healed_trajectory()
    hc = np.array([-(R.T @ t) for _, R, t in heal])
    steps = np.linalg.norm(np.diff(hc, axis=0), axis=1)
    assert steps.max() < 4 * gt_step_max + 0.02, steps.max()
    for (_, Ra, ta), (_, Rh, th) in list(zip(tr.trajectory, heal))[-5:]:
        np.testing.assert_allclose(Ra, Rh, atol=5e-2)
        np.testing.assert_allclose(ta, th, atol=5e-2)
    tr.apply_gauge_correction(delta_R, delta_t)
    tr.reset()
    assert tr._pending_gauge is None and tr._corr_deltas == [] and tr._corr_epoch == 0


def test_pending_gauge_deltas_compose():
    """Two corrections published before the tracker consumes either compose
    as D = D1 ∘ D2."""
    cfg = convert.config_from_dict(dataclasses.asdict(JSlamConfig(camera=JCamera(**KW))))
    tr = ttracking.Tracker(cfg, SlamMap(cfg, device="cpu"))
    rng = np.random.default_rng(0)
    Rs = [np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32) for _ in range(2)]
    Rs = [R * np.sign(np.linalg.det(R)) for R in Rs]
    ts = [rng.normal(size=3).astype(np.float32) for _ in range(2)]
    tr.apply_gauge_correction(Rs[0], ts[0])
    tr.apply_gauge_correction(Rs[1], ts[1])
    R, t = tr._pending_gauge
    np.testing.assert_allclose(R, Rs[0] @ Rs[1], atol=1e-6)
    np.testing.assert_allclose(t, Rs[0] @ ts[1] + ts[0], atol=1e-6)


# ------------------------------------------------------------- workers
class _Inner:
    def __init__(self, fail_on=None):
        self.lock = threading.RLock()
        self.seen = []
        self.fail_on = fail_on
        self.n_loops_closed = 0
        self.last_loop_kf = -1
        self.last_loop_pair = None
        self.enable_gba = True
        self.tracker = None
        self.calls = []
        self.should_abort = None
        self.recent_points, self.recent_lines = [], []
        self.enable_ba = True

    def process_keyframe(self, kf):
        if kf == self.fail_on:
            raise ValueError(f"kf {kf}")
        self.seen.append(kf)

    def fuse(self, kf):
        self.calls.append(("fuse", kf))

    def run_local_ba(self, kf, window=None, **kw):
        self.calls.append(("ba", kf, window, kw))
        return "dense"

    def replace_point(self, loser, winner):
        assert self.lock._is_owned()
        self.calls.append(("replace", loser, winner))


def test_async_loop_closer_records_errors_and_idles():
    inner = _Inner(fail_on=2)
    lc = AsyncLoopCloser(inner)
    try:
        for kf in (1, 2, 3):
            lc.process_keyframe(kf)
        assert lc.wait_idle(timeout=10.0) and lc.idle
        assert inner.seen == [1, 3]
        assert isinstance(lc.error, ValueError)
        lc.tracker = "tr"
        lc.enable_gba = False
        assert inner.tracker == "tr" and inner.enable_gba is False
        assert lc.n_loops_closed == 0 and lc.last_loop_pair is None and lc.last_loop_kf == -1
    finally:
        lc.shutdown()


def test_async_local_mapper_loop_closer_interface():
    """should_abort, fuse, run_local_ba (the global BA's keywords forwarded)
    and replace_point (under the map lock) reach the inner mapper."""
    inner = _Inner()
    lm = AsyncLocalMapper(inner)
    try:
        assert lm.should_abort is inner.should_abort and lm.should_abort() is False
        lm.fuse(4)
        assert lm.run_local_ba(5, window=256, obs_cap=65536, max_kf=7) == "dense"
        lm.replace_point(10, 11)
        assert inner.calls == [("fuse", 4), ("ba", 5, 256, dict(obs_cap=65536, max_kf=7)),
                               ("replace", 10, 11)]
    finally:
        lm.shutdown()


def test_correction_pauses_the_async_mapper():
    """Under AsyncLoopCloser a correction holds the AsyncLocalMapper's pass
    lock (CorrectLoop stops LocalMapping): a keyframe queued for the mapper
    while the correction runs is processed only after it."""
    events = []
    mapper = _Inner()
    mapper.process_keyframe = lambda kf: events.append(("pass", kf))
    lm = AsyncLocalMapper(mapper)
    closer = LoopCloser(None, None, None, None, local_mapper=lm)
    lc = AsyncLoopCloser(closer)
    started, release = threading.Event(), threading.Event()

    def correct(*args):
        events.append("correction started")
        started.set()
        assert release.wait(10.0)
        events.append("correction done")

    closer._correct_loop_paused = correct
    try:
        assert closer.mapping_pause is lm.pass_lock
        t = threading.Thread(target=closer._correct_loop, args=(5, 1, np.eye(3), np.zeros(3)))
        t.start()
        assert started.wait(10.0)
        lm.process_keyframe(7)
        assert not lm.wait_idle(timeout=0.3)  # the pass waits for the correction
        release.set()
        t.join(10.0)
        assert lm.wait_idle(timeout=10.0)
        assert events == ["correction started", "correction done", ("pass", 7)]
    finally:
        release.set()
        lc.shutdown()
        lm.shutdown()
