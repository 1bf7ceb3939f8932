"""The per-layer metrics that read the program's own spans and counts
(``program_spans.py``), on the first cell at the small size on the CPU: a
traced run reports them, the program's spans agree with the harness's
wrappers on the same run, an untraced run leaves the recorder off, and the
accepted files of the benchmark are as they were."""

import hashlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import benchmark
from benchmark import cell
from benchmark.spec import HERE, Spec
from benchmark.tests.conftest import small
from plslam_torch.utils import tracing

NEW = ("matching_ms", "rescue_frame_share", "host_sync_ms", "tracker_offcpu_ms",
       "local_ba_ms", "pose_lm_launches_per_frame")
# the harness's wrapper label -> the program's span that times the same call
AGREE = {"pose_lm": "pose_lm", "build_frame": "track.perception", "finish": "track.finish",
         "mapper": "map.keyframe"}


def _unload():
    """Forget the helper, so that the next reader that imports it runs it
    afresh."""
    sys.modules.pop("benchmark.program_spans", None)
    if hasattr(benchmark, "program_spans"):
        del benchmark.program_spans


@pytest.fixture
def recorder_restored():
    """Each test leaves the process-wide recorder off and empty, and the
    helper unloaded."""
    yield
    tracing.disable()
    tracing.reset()
    _unload()


def _tweak(conf, traffic):
    """The small size, with the profiled slice opening 4 s before the end, so
    that most of a 20 s window comes before it, and the loop four times as
    fast, so that the CPU's ~15 frames before the slice make a keyframe."""
    small(conf, traffic)
    conf["trace_slice"]["before_end_s"] = 4.0
    traffic["period_frames"] //= 4


@pytest.fixture(scope="module")
def traced():
    """One traced run of the first cell, with the harness's ``Run``."""
    seen = []

    class Kept(cell.Run):
        def __init__(self):
            super().__init__()
            seen.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(cell, "Run", Kept)
    _unload()
    tracing.disable()
    try:
        out = cell.run_cell(Spec(), "tum_fr3_rgbd.explore", 2147480011, 20.0, True,
                            time.perf_counter(), device="cpu", tweak=_tweak)
        yield out, seen[0], tracing.spans()
    finally:
        mp.undo()
        tracing.disable()
        tracing.reset()
        _unload()


def test_the_new_metrics_are_declared_for_both_cells():
    spec = Spec()
    for w in ("tum_fr3_rgbd.explore", "tum_fr3_rgbd_fleet4.explore"):
        names = [m["name"] for m in spec.metrics(w, "per_layer")]
        assert all(n in names for n in NEW)


def test_a_traced_run_reports_them(traced):
    out, run, _ = traced
    assert out["correct"], json.dumps(out["checks"])
    assert run.host_frames > 0
    # the device metric needs a CUDA trace
    for name in NEW[:-1]:
        assert name in out["metrics"], name
    assert "pose_lm_launches_per_frame" not in out["metrics"]
    for name in ("matching_ms", "host_sync_ms", "tracker_offcpu_ms", "local_ba_ms"):
        assert out["metrics"][name]["value"] > 0, name


def test_the_program_agrees_with_the_wrappers(traced):
    _, run, spans = traced
    lo, hi = run.t_window[0], run.t_host_end
    for label, name in AGREE.items():
        wrapped = run.span_s(label)
        mine = sum(s["end"] - s["start"] for s in spans
                   if s["name"] == name and lo <= s["start"] < hi)
        assert wrapped > 0, label
        assert abs(mine - wrapped) <= 0.02 * wrapped, (label, mine, wrapped)


def test_self_time_and_kernel_filing(recorder_restored):
    """``self_s`` takes the children's union out of each span;
    ``slice_kernels_in`` files kernel starts by the spans on the host's clock."""
    _unload()
    from benchmark import program_spans

    assert tracing.enabled() and tracing.spans() == []
    t0 = time.perf_counter()
    with tracing.span("outer"):
        with tracing.span("a"):
            time.sleep(0.002)
        with tracing.span("a"):
            pass
    t1 = time.perf_counter()
    run = SimpleNamespace(t_window=(t0, t1), t_host_end=t1, host_frames=1)
    outer, a1, a2 = tracing.spans()
    want = (outer["end"] - outer["start"]) - sum(s["end"] - s["start"] for s in (a1, a2))
    assert program_spans.self_s(run, "outer") == pytest.approx(want, abs=1e-9)
    # one kernel starts inside the first "a", one after every span
    us = [1e6 * ((a1["start"] + a1["end"]) / 2 - t0), 1e6 * (t1 - t0) + 10]
    run.slice = {"t0": t0, "t1": t1, "host_at_zero_s": t0, "frames": 1,
                 "kernels": [("k", u, u + 1) for u in us]}
    assert program_spans.slice_kernels_in(run, "a") == 1
    assert program_spans.slice_kernels_in(run, "outer") == 1
    assert program_spans.slice_kernels_in(run, "none") == 0


def test_an_untraced_run_records_nothing(run_small, recorder_restored):
    tracing.disable()
    _unload()
    out = run_small("tum_fr3_rgbd.explore", 6.0)
    assert out["attempted"] > 0
    assert not tracing.enabled() and tracing.spans() == []
    assert "benchmark.program_spans" not in sys.modules


def test_no_accepted_file_changed():
    accepted = json.loads((Path(__file__).parent / "accepted_files.json").read_text())
    for rel, digest in accepted.items():
        assert hashlib.sha256((HERE / rel).read_bytes()).hexdigest() == digest, rel
