"""plslam_torch relocalization against the plain reference the benchmark's
``reloc`` oracle holds it to (``benchmark/reference_reloc.py``), on the CPU.

The ``System`` facade, wired as ``rgbd_tum`` wires it (vocabulary, keyframe
database, local mapper and loop closer on their threads), runs the blackout
scenario of tests/test_torch_relocalization.py at 320x240 with a second
blackout: 15 tracked frames, 4 blacked-out frames, 4 frames back over views
seen before, 4 more blacked out, 4 more back. Its candidate tries and bags
of words are recorded as they return, and the recorder of utils.tracing is
on. Then:

- every frame with a view gets a pose, each blackout relocalizes on its
  first frame with a view (within 5 cm of the ground truth), no worker
  fails, and the recorder holds ``reloc.won`` 2, ``track.lost`` 8 (the frame
  on which tracking is lost and the three handled in LOST, a blackout) and
  the ``reloc``, ``reloc.candidate``, ``loop.keyframe`` and
  ``bow.transform`` spans;
- ``Vocabulary.transform``: the reference's tree walk gives the same words
  and weights within 1e-6, for every keyframe's and every query's bag;
- ``KeyFrameDatabase.detect_reloc_candidates`` equals the reference's
  candidates on the run's own database and on a seeded random one with a
  culled keyframe;
- ``reloc_match`` (inside ``reloc_candidate_step``) equals the reference's
  match exactly;
- an accepted try's pose lies within 0.01 mm and 1e-3 degrees of the
  reference's (its RANSAC drawn from the same seed, its LM in float64), and
  their inlier counts within 2.
"""

import numpy as np
import pytest
import torch

from benchmark import reference_reloc as rr
from plslam_torch import convert
from plslam_torch.bow import vocabulary as tvoc
from plslam_torch.bow.database import KeyFrameDatabase
from plslam_torch.config import SlamConfig
from plslam_torch.models import relocalization as treloc
from plslam_torch.models.system import System
from plslam_torch.utils import tracing
from test_torch_relocalization import BLACK, center_error, scenario  # noqa: F401
from torch_parity import KW
from torch_parity import few_torch_threads  # noqa: F401

# the scenario's return frames 0-3, a second blackout, return frames 4-7
RETURNS = [(19, 0), (20, 1), (21, 2), (22, 3), (27, 4), (28, 5), (29, 6), (30, 7)]
FIRST_VIEW = (19, 27)


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        return type(x)(*(_copy(v) for v in x)) if hasattr(x, "_fields") else \
            tuple(_copy(v) for v in x)
    return x


@pytest.fixture(scope="module")
def facade(scenario):  # noqa: F811
    """The facade through the two blackouts; (system, poses handed back by
    frame, recorded tries, recorded transforms, spans, counts)."""
    frames, returning, gt = scenario
    seq = frames[:23] + [BLACK] * 4 + frames[23:27]
    cfg = SlamConfig(camera=convert.Camera(**KW), use_lines=False)
    tries, bows = [], []
    orig_step, orig_transform = treloc.reloc_candidate_step, tvoc.Vocabulary.transform

    def step(*a, **k):
        out = orig_step(*a, **k)
        tries.append((_copy(a), a[6].initial_seed(), _copy(out)))
        return out

    def transform(self, desc, valid):
        out = orig_transform(self, desc, valid)
        bows.append((self, desc.clone(), valid.clone(), _copy(out)))
        return out

    was = tracing.enabled()
    tracing.reset()
    tracing.enable()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treloc, "reloc_candidate_step", step)
        mp.setattr(tvoc.Vocabulary, "transform", transform)
        slam = System(cfg, enable_loop_closing=True, async_mapping=True, sensor="rgbd",
                      device="cpu")
        try:
            for i, (g, d) in enumerate(seq):
                slam.track_rgbd(g, d, i / 30.0)
            slam._quiesce()
        finally:
            slam.shutdown()
            spans, counts = tracing.spans(), tracing.counts()
            tracing.reset()
            (tracing.enable if was else tracing.disable)()
    poses = {int(round(ts * 30.0)): (R, t) for ts, R, t in slam.tracker.trajectory}
    return slam, poses, returning, gt, tries, bows, spans, counts


def test_facade_relocalizes_after_each_blackout(facade):
    slam, poses, returning, gt, tries, _, spans, counts = facade
    assert slam.local_mapper.error is None and slam.loop_closer.error is None
    black = set(range(15, 19)) | set(range(23, 27))
    assert set(poses) == set(range(31)) - black  # every frame with a view
    for i, j in RETURNS:
        assert center_error(poses[i], gt, returning[j]) < 0.05, (i, j)
    total = {name: sum(n for _, n in ev) for name, ev in counts.items()}
    assert total["reloc.won"] == 2
    assert total["track.lost"] == 8
    assert total["reloc.candidates"] == len(tries) >= 2
    names = {s["name"] for s in spans}
    assert {"reloc", "reloc.query", "reloc.candidate", "loop.keyframe", "bow.transform",
            "track.bow"} <= names
    by_index = {s["index"]: s for s in spans}
    won = []
    for s in spans:
        if s["name"] == "reloc.candidate":
            assert by_index[s["parent"]]["name"] == "reloc"
            if s["attrs"]["n_inliers"] >= treloc.RELOC_ACCEPT_INLIERS:
                won.append(s["attrs"]["frame"])
    assert won == list(FIRST_VIEW)  # each blackout's first frame with a view
    main = {s["thread"] for s in spans if s["name"] == "reloc"}
    assert len(main) == 1
    assert {s["thread"] for s in spans if s["name"] == "loop.keyframe"}.isdisjoint(main)


def test_transform_equals_the_reference(facade):
    *_, bows, _, _ = facade
    assert len(bows) >= 4
    for voc, desc, valid, (words, weights) in bows:
        ref_words, ref_weights = rr.bow(desc, valid, voc.node_desc, voc.idf)
        assert torch.equal(ref_words, words.long())
        assert float((ref_weights - weights.double()).abs().max()) <= 1e-6


def _reference_candidates(db: KeyFrameDatabase, query, slam_map):
    bows = {kf: db.get_bow(kf) for kf in range(db.max_kf) if db.has[kf]}
    valid = np.asarray(getattr(slam_map, "kf_valid", np.ones(db.max_kf, bool)))
    return rr.reloc_candidates(query, bows, valid, slam_map.covisible_keyframes)


def test_reloc_candidates_equal_the_reference_on_the_run(facade):
    slam, *_, bows, _, _ = facade
    queries = [tvoc.sparse_bow(b[3][1]) for b in bows]
    found = 0
    for q in queries:
        want = _reference_candidates(slam.kfdb, q, slam.map)
        assert slam.kfdb.detect_reloc_candidates(q, slam.map) == want
        found += bool(want)
    assert found >= 2


class _Chain:
    """Covisibility of a chain of keyframes, a culled one among them."""

    def __init__(self, n, culled):
        self.kf_valid = np.zeros(16, bool)
        self.kf_valid[:n] = True
        self.kf_valid[culled] = False
        self.n = n

    def covisible_keyframes(self, kf, k):
        return [c for c in (kf - 1, kf + 1, kf - 2, kf + 2) if 0 <= c < self.n][:k]


def test_reloc_candidates_equal_the_reference_on_a_seeded_database():
    rng = np.random.default_rng(15)
    voc = tvoc.Vocabulary.load(device="cpu")
    db = KeyFrameDatabase(voc, max_kf=16)
    fake = _Chain(12, culled=5)

    def sparse():
        ids = np.unique(rng.integers(0, 300, rng.integers(40, 80)))
        vals = rng.random(len(ids)).astype(np.float32)
        return ids, vals / vals.sum()

    for kf in range(12):
        db.add(kf, sparse())
    db.erase(9)
    n_cands = 0
    for _ in range(30):
        q = sparse()
        want = _reference_candidates(db, q, fake)
        assert db.detect_reloc_candidates(q, fake) == want
        n_cands += len(want)
    assert n_cands > 30


def test_reloc_match_equals_the_reference(facade):
    slam, *_, tries, _, _, _ = facade
    for (cfg, fd, kf_desc, kf_angle, kf_has, _, _), _, out in tries:
        want = rr.reloc_match(fd.kp_desc, fd.kp_valid, fd.kp_angle, kf_desc, kf_angle, kf_has,
                              cfg.matcher.nn_ratio_reloc)
        assert torch.equal(want, out[2].long())
        if int(out[4]) >= treloc.RELOC_ACCEPT_INLIERS:
            assert int((want >= 0).sum()) >= treloc.RELOC_ACCEPT_INLIERS


def test_candidate_pose_near_the_reference(facade):
    *_, tries, _, _, _ = facade
    accepted = 0
    for (cfg, fd, _, _, _, kf_pt_w, _), seed, (R, t, idx, _, n) in tries:
        if int(n) < treloc.RELOC_ACCEPT_INLIERS:
            continue
        accepted += 1
        f = {k: getattr(fd, k) for k in ("kp_xy_un", "kp_ur", "kp_octave", "kp_depth")}
        Rr, tr, nr = rr.reloc_pose(cfg.camera, cfg.orb.scale_factor, f, idx.long(), kf_pt_w,
                                   seed)
        assert rr.centre_gap_mm(R, t, Rr, tr) < 0.01
        assert rr.rotation_deg(R, Rr) < 1e-3
        assert abs(nr - int(n)) <= 2
    assert accepted == 2

