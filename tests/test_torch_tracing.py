"""plslam_torch.utils.tracing: the recorder, and the spans and counts the
port opens where its work happens.

1. The recorder alone: while it is off nothing is recorded, ``span()``
   returns the shared ``NOOP`` and ``locked(lock)`` is ``lock``; while it
   is on, spans nest per thread, roots alone carry the thread's CPU time,
   children take ``frame`` and ``session`` from their parents, counts are
   time-stamped, and past the capacity records are dropped and counted.
2. Twelve 320x240 frames of a fast orbit (100 frames a turn) through a
   ``Tracker`` with a synchronous ``LocalMapper``, with recording off and
   on: the trajectories and the per-frame stats are bit-identical, and
   every frame leaves the span tree of the module docstring, its spans
   sharing its ``frame`` id and its retirement the retired frame's (the
   third keyframe, at frame 9, runs a local BA).
3. Six steps of a two-session ``MultiTracker``, session 1 given a wrong
   velocity prior at step 3 (the rescue takes its frame): bit-identical
   with recording off and on; every step leaves a ``multi.step`` root with
   the batched stages under it, each session's retirement under its own
   ``track.frame``, and the rescue's counts.
4. ``System(trace_path=...)`` turns recording on and writes "span" and
   "count" records beside the "frame" records at shutdown, then turns it
   off.
"""

import json
import threading

import numpy as np
import pytest
import torch

from plslam_torch import convert
from plslam_torch.config import SlamConfig
from plslam_torch.models import tracking as T
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.map import SlamMap
from plslam_torch.models.system import System
from plslam_torch.parallel.multiseq import MultiTracker
from plslam_torch.utils import tracing
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory
from torch_parity import KW
from torch_parity import few_torch_threads  # noqa: F401

STAGES = ["track.perception", "track.motion", "sync.rescue", "track.local"]
WRONG_AT = 3


@pytest.fixture(autouse=True)
def recorder_state():
    """The recorder is process-wide: every test starts it empty and leaves
    it as it found it, on or off, and empty."""
    was = tracing.enabled()
    tracing.reset()
    yield
    tracing.reset()
    (tracing.enable if was else tracing.disable)()


def _render(seed, n, total):
    scene = RoomScene(seed)
    cam = convert.Camera(**KW)
    out = []
    for R, t in smooth_trajectory(total)[:n]:
        g, d = scene.render(cam, R, t)
        out.append((np.clip(g, 0, 255).astype(np.uint8),
                    np.clip(d * 5000.0, 0, 65535).astype(np.uint16)))
    return out


@pytest.fixture(scope="module")
def cfg():
    return SlamConfig(camera=convert.Camera(**KW))


def _tree(spans):
    """Children by parent index, in order."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    return kids


def _names(spans):
    return [s["name"] for s in spans]


def _wrong_prior(tr):
    """A velocity prior 20 degrees and 0.4 m off: the motion stage starves."""
    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    tr._R_vel = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32)
    tr._t_vel = torch.tensor([0.4, 0.0, 0.0])


# ------------------------------------------------------------- 1. recorder
def test_off_records_nothing():
    tracing.disable()
    assert tracing.span("track.frame", frame=0) is tracing.NOOP
    with tracing.span("a") as s:
        assert s is tracing.NOOP
        tracing.count("c", 3)
    lock = threading.RLock()
    assert tracing.locked(lock) is lock
    assert tracing.spans() == [] and tracing.counts() == {} and tracing.dropped() == 0


def test_spans_nest_per_thread():
    tracing.enable()
    with tracing.span("root", frame=7, session=1):
        with tracing.span("child", session=2):
            with tracing.span("leaf", k=1):
                tracing.count("c", 2)
        seen = []
        t = threading.Thread(target=lambda: seen.append(tracing.span("other").__enter__()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    tracing.count("c")
    spans = tracing.spans()
    # the other thread's span never closed: not reported
    assert _names(spans) == ["root", "child", "leaf"]
    root, child, leaf = spans
    assert [s["parent"] for s in spans] == [-1, root["index"], child["index"]]
    assert root["attrs"] == {"frame": 7, "session": 1}
    assert child["attrs"] == {"session": 2, "frame": 7}
    assert leaf["attrs"] == {"k": 1, "session": 2, "frame": 7}
    assert root["cpu_s"] is not None and root["cpu_s"] >= 0
    assert child["cpu_s"] is None and leaf["cpu_s"] is None
    assert {s["thread"] for s in spans} == {threading.get_ident()}
    assert root["start"] <= child["start"] <= leaf["start"] <= leaf["end"] <= root["end"]
    (t0, n0), (t1, n1) = tracing.counts()["c"]
    assert (n0, n1) == (2, 1) and leaf["start"] <= t0 <= leaf["end"] <= root["end"] <= t1


def test_locked_records_the_wait():
    tracing.enable()
    lock = threading.RLock()
    with tracing.locked(lock):
        assert lock._is_owned()
    assert not lock._is_owned()
    assert _names(tracing.spans()) == ["lock.wait"]


def test_capacity_drops_and_reset_forgets():
    rec = tracing.Recorder(capacity=3)
    rec.enable()
    for _ in range(3):
        with rec.span("s"):
            rec.count("c")
    assert len(rec.spans()) == 2 and len(rec.counts()["c"]) == 1
    assert rec.dropped() == 3
    rec.reset()
    assert rec.spans() == [] and rec.counts() == {} and rec.dropped() == 0
    with rec.span("again"):
        pass
    assert _names(rec.spans()) == ["again"]


# ------------------------------------------------------ 2. a solo sequence
def _run_solo(cfg, frames, on):
    tracing.reset()
    (tracing.enable if on else tracing.disable)()
    m = SlamMap(cfg, device="cpu")
    tr = T.Tracker(cfg, m, local_mapper=LocalMapper(cfg, m))
    stats = []
    for i, (g, d) in enumerate(frames):
        tr.process(g, d, i / 30.0)
        stats.append(dict(tr.debug))
    tr.flush()
    stats.append(dict(tr.debug))
    tracing.disable()
    return tr, stats, tracing.spans(), tracing.counts()


@pytest.fixture(scope="module")
def solo_runs(cfg):
    frames = _render(0, 12, total=100)
    was = tracing.enabled()
    try:
        return _run_solo(cfg, frames, False), _run_solo(cfg, frames, True)
    finally:
        tracing.reset()
        (tracing.enable if was else tracing.disable)()


def _same_run(a, b):
    assert len(a.trajectory) == len(b.trajectory)
    for (ta, Ra, tra), (tb, Rb, trb) in zip(a.trajectory, b.trajectory):
        assert ta == tb
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(tra, trb)


def test_solo_bit_identical_with_recording(solo_runs):
    (off, off_stats, off_spans, _), (on, on_stats, on_spans, _) = solo_runs
    assert off_spans == [] and on_spans
    _same_run(off, on)
    assert off_stats == on_stats
    assert off.map.n_kf == on.map.n_kf >= 3


def _subtree(kids, s):
    out = []
    for c in kids.get(s["index"], []):
        out.append(c)
        out += _subtree(kids, c)
    return out


def test_solo_span_tree(solo_runs):
    tr, _, spans, counts = solo_runs[1]
    kids = _tree(spans)
    roots = kids[-1]
    frames = [s for s in roots if s["name"] == "track.frame"]
    assert [s["attrs"]["frame"] for s in frames] == list(range(12))
    # the last frame retires in flush: a root of its own
    assert _names(roots) == ["track.frame"] * 12 + ["track.finish"]
    assert roots[-1]["attrs"]["frame"] == 11
    assert all(s["cpu_s"] is not None for s in roots)
    assert counts == {}  # the orbit never starves the motion stage
    kf_frames, ba = [], 0
    for f in frames[1:]:
        fid = f["attrs"]["frame"]
        top = kids[f["index"]]
        assert _names(top)[:5] == ["sync.upload"] + STAGES, fid
        for stage in ("track.motion", "track.local"):
            (st,) = [s for s in top if s["name"] == stage]
            assert _names(kids[st["index"]]) == ["match", "pose_lm"]
        finish = [s for s in top if s["name"] == "track.finish"]
        if fid == 1:
            assert finish == []  # lag-1: nothing retires yet
            continue
        (fin,) = finish
        # the retirement is the previous frame's
        assert fin["attrs"]["frame"] == fid - 1
        assert all(s["attrs"]["frame"] == fid - 1 for s in _subtree(kids, fin))
        assert all(s["attrs"]["frame"] == fid for s in _subtree(kids, f)
                   if s is not fin and s not in _subtree(kids, fin))
        assert all(s["attrs"]["session"] is None for s in _subtree(kids, f))
        under = kids[fin["index"]]
        assert _names(under)[:2] == ["sync.retire", "lock.wait"]
        for kf in (s for s in under if s["name"] == "track.keyframe"):
            kf_frames.append(fid - 1)
            mk = [s for s in kids[kf["index"]] if s["name"] == "map.keyframe"]
            assert len(mk) == 1 and tr.map.kf_frame_id[mk[0]["attrs"]["kf"]] == fid - 1
            ba += sum(s["name"] == "map.local_ba" for s in kids.get(mk[0]["index"], []))
            assert _names(kids[kf["index"]])[-1] == "track.local_map"
    assert len(kf_frames) == tr.map.n_kf - 1 >= 2 and ba >= 1
    # every span of the sequence but the roots hangs under one
    assert sum(len(_subtree(kids, r)) for r in roots) + len(roots) == len(spans)


# --------------------------------------------- 3. a two-session MultiTracker
def _run_multi(cfg, seqs, on):
    tracing.reset()
    (tracing.enable if on else tracing.disable)()
    trs = [T.Tracker(cfg, SlamMap(cfg, device="cpu")) for _ in seqs]
    mt = MultiTracker(trs)
    stats = []
    for i in range(len(seqs[0])):
        if i == WRONG_AT:
            _wrong_prior(trs[1])
        mt.process([q[i] for q in seqs], [i / 30.0] * len(seqs))
        stats.append([dict(tr.debug) for tr in trs])
    mt.flush()
    tracing.disable()
    return trs, stats, tracing.spans(), tracing.counts()


@pytest.fixture(scope="module")
def multi_runs(cfg):
    seqs = [_render(s, 6, total=300) for s in (0, 1)]
    was = tracing.enabled()
    try:
        return _run_multi(cfg, seqs, False), _run_multi(cfg, seqs, True)
    finally:
        tracing.reset()
        (tracing.enable if was else tracing.disable)()


def test_multi_bit_identical_with_recording(multi_runs):
    (off, off_stats, off_spans, _), (on, on_stats, _, _) = multi_runs
    assert off_spans == []
    for a, b in zip(off, on):
        _same_run(a, b)
    assert off_stats == on_stats
    # the wrong prior's frame was carried by the rescue
    assert on_stats[WRONG_AT + 1][1]["rescue_inliers"] > 100


def test_multi_span_tree(multi_runs):
    _, _, spans, counts = multi_runs[1]
    kids = _tree(spans)
    steps = [s for s in kids[-1] if s["name"] == "multi.step"]
    assert len(steps) == 6
    assert all(s["cpu_s"] is not None for s in steps)
    for k, st in enumerate(steps):
        a = st["attrs"]
        assert a["frame"] == [k, k]
        under = kids.get(st["index"], [])
        if k == 0:  # both sessions initialize, each in a solo step
            assert a["batched"] == 0
            assert _names(under) == ["track.frame", "track.frame"]
            assert [s["attrs"]["session"] for s in under] == [0, 1]
            continue
        assert a["batched"] == 2 and a["step"] == k - 1
        stages = STAGES[:3] + (["track.rescue"] if k == WRONG_AT else []) + STAGES[3:]
        assert _names(under) == ["sync.upload"] + stages + ["track.frame", "track.frame"]
        sessions = under[-2:]
        assert [s["attrs"]["session"] for s in sessions] == [0, 1]
        assert [s["attrs"]["frame"] for s in sessions] == [k, k]
        for s in under[:-2]:
            assert s["attrs"]["frame"] == [k, k] and "session" not in s["attrs"]
        for sess in sessions:
            fin = kids.get(sess["index"], [])
            if k == 1:
                assert fin == []  # lag-1
                continue
            assert _names(fin) == ["track.finish"]
            assert fin[0]["attrs"]["frame"] == k - 1
            assert fin[0]["attrs"]["session"] == sess["attrs"]["session"]
            assert _names(kids[fin[0]["index"]])[0] == "sync.retire"
        if k == WRONG_AT:
            (rescue,) = [s for s in under if s["name"] == "track.rescue"]
            assert _names(kids[rescue["index"]]) == ["match", "pose_lm", "sync.rescue"]
    assert [n for _, n in counts["track.rescue.rows"]] == [1]
    assert [n for _, n in counts["track.rescue.won"]] == [1]
    (t_rows, _), = counts["track.rescue.rows"]
    assert steps[WRONG_AT]["start"] <= t_rows <= steps[WRONG_AT]["end"]


# ---------------------------------------------------------------- 4. System
def test_system_writes_spans_and_counts(cfg, tmp_path):
    tracing.disable()
    frames = _render(0, 5, total=300)
    path = tmp_path / "trace.jsonl"
    slam = System(cfg, trace_path=str(path), enable_loop_closing=False, device="cpu")
    assert tracing.enabled()
    for i, (g, d) in enumerate(frames):
        if i == WRONG_AT:
            _wrong_prior(slam.tracker)
        slam.track_rgbd(g, d, i / 30.0)
    slam.shutdown()
    assert not tracing.enabled()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("frame") == 4  # frames 1-4 retire, the last at shutdown
    spans = [r for r in recs if r["kind"] == "span"]
    assert _names(spans).count("track.frame") == 5
    for r in spans:
        assert 0 <= r["start"] <= r["end"] and -1 <= r["parent"] < len(spans)
        assert (r["parent"] == -1) == ("cpu_s" in r)
    assert [(r["name"], r["n"]) for r in recs if r["kind"] == "count"] == [
        ("track.rescue.rows", 1), ("track.rescue.won", 1)]
    # nothing more is recorded once the system is shut down
    with tracing.span("after"):
        pass
    assert "after" not in _names(tracing.spans())
