"""plslam_torch.parallel.multiseq: B tracking sessions in one batched step.

At 320x240 with B = 2 sequences (RoomScene(0) and RoomScene(1) on the
same trajectory), every test with its tolerance:

(a) the port's batched step against the JAX package's vmapped
    ``_batched_step`` on the same stacked inputs, per sequence, within
    ``test_torch_tracking._assert_steps_agree``'s bounds (1e-3 m / rad,
    stats within 2%, 98% of the bindings), from the velocity prior and with
    a wrong prior on one sequence (the JAX package's rescue is a select per
    sequence under vmap, the port's a sub-batch);
(b) ``MultiTracker`` against B solo port trackers: every state, stat and
    binding equal, poses within 1e-5 (on the CPU the batched arithmetic is
    the solo arithmetic, so they come out equal);
(c) one sequence forced into the rescue (a wrong velocity prior) while the
    other has a gauge correction pending: the rescue runs on a sub-batch of
    one and equals the solo rescue, and the correction is applied before
    the batched step reads the pose, as the solo tracker applies it;
(d) one sequence blacked out: it leaves the batch, steps solo, and matches
    its solo run;
(e) a batch of two stereo trackers against solo;
(f) the plain versions of both kernels with a batch axis (FAST over B
    images, Hamming with one query set per problem) equal loops of their
    single-image and shared-query forms, exactly;
(g) a batch rejects trackers of mixed sensors, configs or none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_tpu.parallel.multiseq import _batched_step as jax_batched_step
from plslam_torch import convert
from plslam_torch.models import tracking as T
from plslam_torch.models.frame import FrameData
from plslam_torch.models.map import SlamMap
from plslam_torch.ops import fast, hamming
from plslam_torch.parallel import multiseq
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory
from test_torch_tracking import _assert_steps_agree
from torch_parity import KW, map_arrays
from torch_parity import few_torch_threads  # noqa: F401

B = 2
N_FRAMES = 6
POSE_TOL = 1e-5
WRONG_AT = 3  # the frame dispatched with a wrong prior / a pending correction


def _render(seed, n, stereo=False):
    scene = RoomScene(seed)
    cam = convert.Camera(**KW)
    out = []
    for R, t in smooth_trajectory(300)[:n]:
        g, d = scene.render(cam, R, t)
        g = np.clip(g, 0, 255).astype(np.uint8)
        if stereo:
            gr, _ = scene.render(cam, R, t - np.array([cam.bf / cam.fx, 0, 0], np.float32))
            out.append((g, np.clip(gr, 0, 255).astype(np.uint8)))
        else:
            out.append((g, np.clip(d * 5000.0, 0, 65535).astype(np.uint16)))
    return out


@pytest.fixture(scope="module")
def jcfg():
    return JSlamConfig(camera=JCamera(**KW))


@pytest.fixture(scope="module")
def cfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def seqs():
    return [_render(s, N_FRAMES) for s in range(B)]


def _wrong_prior():
    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return R, np.array([0.4, 0.0, 0.0], np.float32)


def _gauge_delta():
    a = np.radians(0.5)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                 np.float32)
    return R, np.array([0.01, 0.0, 0.0], np.float32)


def _perturb(s, tr):
    """Before frame WRONG_AT: sequence 0 gets a gauge correction published,
    sequence 1 a wrong velocity prior."""
    if s == 0:
        tr.apply_gauge_correction(*_gauge_delta())
    else:
        R, t = _wrong_prior()
        tr._R_vel, tr._t_vel = torch.from_numpy(R), torch.from_numpy(t)


def _log(tr):
    return dict(state=tr.state, debug=dict(tr.debug), pt_ids=None if tr.last_pt_ids is None
                else tr.last_pt_ids.copy())


def _run_solo(cfg, frames, perturb=None, sensor="rgbd"):
    tr = T.Tracker(cfg, SlamMap(cfg, device="cpu"), sensor=sensor)
    logs = []
    for i, (g, d) in enumerate(frames):
        if perturb is not None and i == WRONG_AT:
            perturb(tr)
        tr.process(g, d, i / 30.0)
        logs.append(_log(tr))
    tr.flush()
    return tr, logs


def _run_multi(cfg, seqs_, perturb=None, sensor="rgbd"):
    trs = [T.Tracker(cfg, SlamMap(cfg, device="cpu"), sensor=sensor) for _ in seqs_]
    mt = multiseq.MultiTracker(trs)
    logs = [[] for _ in seqs_]
    for i in range(len(seqs_[0])):
        if perturb is not None and i == WRONG_AT:
            for s, tr in enumerate(trs):
                perturb(s, tr)
        mt.process([q[i] for q in seqs_], [i / 30.0] * len(seqs_))
        for s, tr in enumerate(trs):
            logs[s].append(_log(tr))
    mt.flush()
    return mt, logs


def _assert_same_run(solo, solo_logs, tr, logs):
    """Integer outputs equal frame by frame, poses within POSE_TOL."""
    for i, (a, b) in enumerate(zip(solo_logs, logs)):
        assert a["state"] == b["state"], i
        assert a["debug"] == b["debug"], i
        if a["pt_ids"] is None:
            assert b["pt_ids"] is None, i
        else:
            np.testing.assert_array_equal(a["pt_ids"], b["pt_ids"], err_msg=str(i))
    assert solo.state == tr.state
    assert len(solo.trajectory) == len(tr.trajectory)
    for (ta, Ra, tta), (tb, Rb, ttb) in zip(solo.trajectory, tr.trajectory):
        assert ta == tb
        assert np.abs(Ra - Rb).max() <= POSE_TOL
        assert np.abs(tta - ttb).max() <= POSE_TOL
    assert (solo.map.n_kf, solo.map.n_points(), solo.map.n_lines()) == (
        tr.map.n_kf, tr.map.n_points(), tr.map.n_lines())


@pytest.fixture(scope="module")
def solo_runs(cfg, seqs):
    return [_run_solo(cfg, frames) for frames in seqs]


# --------------------------------------------------------------- (a) JAX
@pytest.fixture(scope="module")
def seeded(jcfg, cfg, seqs):
    """Per sequence, a JAX tracker initialized on frame 0 and a port
    tracker seeded from its map, prior frame, pose and local map."""
    out = []
    for frames in seqs:
        jt = jtracking.Tracker(jcfg, JSlamMap(jcfg))
        jt.process(*frames[0], 0.0)
        assert jt.state == jtracking.OK
        m = convert.map_from_numpy(map_arrays(jt.map), cfg, device="cpu")
        tr = T.Tracker(cfg, m)
        tr.state = T.OK
        tr.frame_id, tr.last_kf_id = jt.frame_id, jt.last_kf_id
        tr.last_kf, tr.ref_kf = jt.last_kf, jt.ref_kf
        tr._prev_fd = FrameData(*(torch.tensor(np.asarray(getattr(jt._prev_fd, f)))
                                  for f in FrameData._fields))
        tr._R = torch.tensor(np.asarray(jt._R))
        tr._t = torch.tensor(np.asarray(jt._t))
        tr._refresh_local_map(jt.last_pt_ids, jt.last_ln_ids)
        out.append((jt, tr))
    return out


@pytest.mark.parametrize("prior", ["velocity", "wrong_on_seq1"])
def test_batched_step_matches_jax(jcfg, cfg, seqs, seeded, prior):
    jargs, targs, jin, tin = [], [], [], []
    for s, (jt, tr) in enumerate(seeded):
        # after the initializing frame neither has a velocity: both guess
        # the last pose, unless sequence 1 is given a wrong prior
        ja, ta = list(jt.dispatch_args()), list(tr.dispatch_args())
        if prior == "wrong_on_seq1" and s == 1:
            R, t = _wrong_prior()
            ja[7:10] = [jnp.asarray(R), jnp.asarray(t), jnp.asarray(True)]
            ta[7:10] = [torch.from_numpy(R), torch.from_numpy(t), True]
        jargs.append(tuple(ja))
        targs.append(tuple(ta))
        jin.append(jt._quantize_inputs(*seqs[s][1]))
        g, d = tr._quantize_inputs(*seqs[s][1])
        tin.append((g, d.astype(np.int32)))
    jo = jax_batched_step(jcfg, *(jnp.asarray(np.stack(x)) for x in zip(*jin)),
                          jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jargs))
    to = multiseq.batched_step(cfg, *(torch.from_numpy(np.stack(x)) for x in zip(*tin)),
                               multiseq.stack_args(targs))
    for s in range(B):
        jos = jax.tree_util.tree_map(lambda a: a[s], jo)
        tos = multiseq.slice_out(to, s)
        rescued = prior == "wrong_on_seq1" and s == 1
        js, ts = np.asarray(jos.stats), tos.stats.numpy()
        assert (js[5] > 100) == (ts[5] > 100) == rescued, (s, js, ts)
        _assert_steps_agree(jos, tos)


# ------------------------------------------------------------ (b) solo
def test_multitracker_matches_solo(cfg, seqs, solo_runs):
    mt, logs = _run_multi(cfg, seqs)
    assert mt.steps == N_FRAMES - 1  # frame 0 initializes, solo
    assert mt.batched_frames == B * (N_FRAMES - 1)
    for s in range(B):
        assert mt.trackers[s].state == T.OK and mt.trackers[s].map.n_kf >= 2
        _assert_same_run(*solo_runs[s], mt.trackers[s], logs[s])


# ---------------------------------------------------- (c) rescue, gauge
def test_sub_batch_rescue_and_gauge_match_solo(cfg, seqs, monkeypatch):
    solo = [_run_solo(cfg, frames, perturb=lambda tr, s=s: _perturb(s, tr))
            for s, frames in enumerate(seqs)]
    batch_sizes = []
    core = T._rescue_core

    def recording(cfg_, fd, *a):
        batch_sizes.append(fd.kp_valid.shape[:-1])
        return core(cfg_, fd, *a)

    monkeypatch.setattr(T, "_rescue_core", recording)
    mt, logs = _run_multi(cfg, seqs, perturb=_perturb)
    # the solo runs rescued once (unbatched), the batch once, on a sub-batch of one
    assert batch_sizes == [torch.Size([1])]
    assert logs[1][WRONG_AT + 1]["debug"]["rescue_inliers"] > 100
    assert all(x["debug"].get("rescue_inliers", 0) == 0 for x in logs[0])
    for s in range(B):
        _assert_same_run(*solo[s], mt.trackers[s], logs[s])


# ------------------------------------------------------------- (d) LOST
def test_blacked_out_sequence_steps_solo(cfg, seqs, solo_runs):
    black = (np.full_like(seqs[1][0][0], 128), np.zeros_like(seqs[1][0][1]))
    seq1 = [black if i in (2, 3) else f for i, f in enumerate(seqs[1])]
    solo1 = _run_solo(cfg, seq1)
    mt, logs = _run_multi(cfg, [seqs[0], seq1])
    assert solo1[0].state == mt.trackers[1].state == T.LOST
    assert mt.batched_frames < B * (N_FRAMES - 1)  # sequence 1 left the batch
    _assert_same_run(*solo_runs[0], mt.trackers[0], logs[0])
    _assert_same_run(*solo1, mt.trackers[1], logs[1])


# ----------------------------------------------------------- (e) stereo
def test_stereo_batch_matches_solo(cfg):
    pairs = [_render(s, 5, stereo=True) for s in range(B)]
    solo = [_run_solo(cfg, p, sensor="stereo") for p in pairs]
    mt, logs = _run_multi(cfg, pairs, sensor="stereo")
    assert mt.steps == 4
    for s in range(B):
        assert solo[s][0].sensor == "stereo" and solo[s][0].state == T.OK
        _assert_same_run(*solo[s], mt.trackers[s], logs[s])


# ------------------------------------------------------- (f) kernels
def test_fast_plain_with_a_batch_axis():
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.integers(0, 256, (3, 2, 37, 53)).astype(np.float32))
    got = fast.fast_score_nms_plain(imgs, 7.0)
    for i in np.ndindex(3, 2):
        assert torch.equal(got[i], fast.fast_score_nms_plain(imgs[i], 7.0))
    levels = [imgs[:, 0], imgs[:, 1, :31, :40]]  # two "levels" of 3 images
    for lvl, g in zip(levels, fast.fast_score_nms_levels([x.contiguous() for x in levels], 7.0)):
        for b in range(3):
            assert torch.equal(g[b], fast.fast_score_nms_plain(lvl[b], 7.0))


def _hamming_problems(rng, nb, n, m):
    q = torch.as_tensor(rng.integers(0, 256, (nb, n, 32), dtype=np.uint8))
    t = torch.as_tensor(rng.integers(0, 256, (nb, m, 32), dtype=np.uint8))
    t[:, 10:20] = q[:, :10]  # exact twins, ties on the best distance
    t[:, 30:40] = q[:, :10]
    gate = torch.as_tensor(rng.random((nb, n, m)) < 0.4)
    gate[:, :10, 10:20] = True
    gate[:, :10, 30:40] = True
    gate[:, 5] = False  # a row with nothing gated
    return q, t, gate


def test_hamming_plain_per_problem_queries():
    rng = np.random.default_rng(1)
    q, t, gate = _hamming_problems(rng, 3, 50, 77)
    loop = [hamming.hamming_top2_plain(q[b], t[b], gate[b]) for b in range(3)]
    for per_problem in (hamming.hamming_top2_plain(q, t, gate), hamming.hamming_top2(q, t, gate)):
        for k in range(3):
            assert torch.equal(per_problem[k], torch.stack([x[k] for x in loop]))
    # shared queries: the per-problem form of the same set equals the shared form
    shared = hamming.hamming_top2_batched(q[0], t, gate)
    same = hamming.hamming_top2_plain(q[0].expand(3, -1, -1), t, gate)
    for a, b in zip(shared, same):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):  # the shared-query launch takes one query set
        hamming.hamming_top2_batched(q, t, gate)
    # the twins: the lowest index wins the tie, a gated-out row is -1
    idx = loop[0][1]
    assert (idx[:5] == torch.arange(10, 15, dtype=torch.int32)).all() and idx[5] == -1


# ------------------------------------------------------- (g) rejection
def test_batch_rejects_mixed_trackers(cfg):
    m = lambda: SlamMap(cfg, device="cpu")  # noqa: E731
    with pytest.raises(ValueError):
        multiseq.MultiTracker([])
    with pytest.raises(ValueError, match="sensor"):
        multiseq.MultiTracker([T.Tracker(cfg, m()), T.Tracker(cfg, m(), sensor="stereo")])
    other = dataclasses.replace(cfg, use_lines=not cfg.use_lines)
    with pytest.raises(ValueError, match="SlamConfig"):
        multiseq.MultiTracker([T.Tracker(cfg, m()), T.Tracker(other, SlamMap(other, device="cpu"))])
    # an equal config in another object is one config
    same = convert.config_from_dict(dataclasses.asdict(cfg))
    assert multiseq.MultiTracker([T.Tracker(cfg, m()), T.Tracker(same, m())]).sensor == "rgbd"
