"""The occlusion cell: the ``System`` facade through blackouts, at the small
size on the CPU.

- A traced run is correct, every frame with a view gets a pose, and the
  four metrics of the relocalization, tracker, loop-closing and
  place-recognition layers are there.
- A relocalized pose shifted by 5 cm where it is produced comes out not
  correct, through ``reloc_pose_gap_mm``; so does a keyframe database that
  answers a relocalization query with one candidate too many, through
  ``reloc_candidate_mismatch_share``.
- The vocabulary has the published one's shape (k 10, 6 levels, 10^6
  words), its top levels the trained file's; the ``reloc`` oracle keeps as
  many relocalizations as the configuration samples.
- The readers of those metrics read nothing, not zero, from a program that
  records none of their names (an older program).
- The plain reference of relocalization imports nothing of the program.
"""

import ast
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import plslam_torch.models.relocalization as relocalization
from benchmark.cell import run_cell
from benchmark.spec import ROOT, Spec
from benchmark.tests.conftest import small
from plslam_torch.bow.database import KeyFrameDatabase
from plslam_torch.utils import tracing

CELL = "tum_fr3_rgbd_slam.occlusion"
METRICS = ("reloc_ms", "lost_frame_share", "loop_detect_ms", "bow_ms")
SECONDS = 60.0


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads while the module runs: the system's worker
    threads share the host with the tracker's, and the small eager ops lose
    time to thread hand-offs on a busy host."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


def _run(trace=False):
    """One run at the small size with short, frequent blackouts (2 frames of
    every 6, the first at frame 9), so that a relocalization comes within a
    CPU window's first few frames even on a slow host, and 120 rendered
    frames, so that a fast host's window does not wrap back to the first
    view (a jump no tracker follows)."""
    def tweak(conf, traffic):
        small(conf, traffic)
        conf["sequence_frames"] = 120
        traffic["blackout"] = {"every": 6, "frames": 2}
    return run_cell(Spec(), CELL, 987654321012, SECONDS, trace, time.perf_counter(),
                    device="cpu", tweak=tweak)


def test_the_cell_runs_correct_with_its_metrics():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["frames_without_pose"]["value"] == 0
    assert out["failed"] >= 4  # the blacked-out frames
    for name in METRICS:
        assert name in out["metrics"], name
    assert out["metrics"]["reloc_ms"]["value"] > 0
    assert out["metrics"]["lost_frame_share"]["value"] > 0


def test_a_relocalized_pose_shifted_by_5_cm(monkeypatch):
    orig = relocalization.reloc_candidate_step

    def shifted(*a, **k):
        R, t, idx, inl, n = orig(*a, **k)
        return R, t + torch.tensor([0.05, 0.0, 0.0], device=t.device), idx, inl, n
    monkeypatch.setattr(relocalization, "reloc_candidate_step", shifted)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["reloc_pose_gap_mm"]["value"] > 40.0


def test_a_candidate_too_many(monkeypatch):
    orig = KeyFrameDatabase.detect_reloc_candidates

    def one_more(self, bow, slam_map):
        out = orig(self, bow, slam_map)
        extra = [kf for kf in np.nonzero(self.has)[0].tolist() if kf not in out]
        return out + extra[:1]
    monkeypatch.setattr(KeyFrameDatabase, "detect_reloc_candidates", one_more)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["reloc_candidate_mismatch_share"]["value"] > 0


def test_the_vocabulary_has_the_published_shape():
    spec = Spec()
    conf = spec.config("tum_fr3_rgbd_slam")
    levels, idf = spec.system("slam").vocabulary_levels(conf)
    pub = conf["published"]["vocabulary"]
    assert [c.shape for c in levels] == [(pub["k"] ** (lvl + 1), 32)
                                         for lvl in range(pub["levels"])]
    assert idf.shape == (10 ** 6,) and np.isfinite(idf).all() and idf.min() > 0
    trained = np.load(os.path.join(ROOT, conf["vocabulary"]["trained_levels"]["file"]))
    for lvl in range(4):
        assert np.array_equal(levels[lvl], trained[f"level_{lvl}"])
    flips = np.unpackbits(levels[5] ^ np.repeat(levels[4], 10, axis=0)).mean()
    assert abs(flips - conf["vocabulary"]["seeded_levels"]["bit_flip"]) < 1e-3


def test_the_oracle_keeps_as_many_relocalizations_as_are_sampled():
    spec = Spec()
    conf = spec.config("tum_fr3_rgbd_slam")
    assert spec.oracle("reloc").MAX_RELOCS == conf["correct"]["max_samples"]


def test_readers_read_nothing_without_the_names(monkeypatch):
    spec = Spec()
    readers = [spec.reader(name) for name in METRICS]
    monkeypatch.setattr(tracing.RECORDER, "_on", True)
    tracing.reset()
    with tracing.span("track.frame"):
        tracing.count("track.rescue.rows", 0)

    class Run:
        t_window = (0.0, 1e12)
        t_host_end = 1e12
        host_frames = 10
    try:
        assert [r.read(Run()) for r in readers] == [None] * len(METRICS)
        with tracing.span("reloc"), tracing.span("bow.transform"):
            tracing.count("track.lost")
        with tracing.span("loop.keyframe"):
            pass
        got = [r.read(Run()) for r in readers]
        assert all(v is not None for v in got) and got[1] == 10.0
    finally:
        tracing.reset()


def test_the_reference_imports_nothing_of_the_program():
    path = Path(__file__).resolve().parent.parent / "reference_reloc.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("plslam_torch", "plslam_tpu", "jax"), name
