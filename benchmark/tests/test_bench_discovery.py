"""A configuration, a traffic mix, a system, a sensor and a metric added as
new files are found by name and run, with no file of the benchmark edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from benchmark.cell import run_cell
from benchmark.spec import ROOT, Spec

# two cameras, each with a tracker of its own stepped alone: a wiring that
# neither of the benchmark's systems has
SYSTEM = '''
from benchmark.cell import System

SEEN = []


class Each(System):
    def __init__(self, cfg, conf, device):
        super().__init__(cfg, conf, device, conf["sessions"])
        self.counters = self.trackers[0]

    def step(self, frames, timestamps):
        for tr, (gray, depth), ts in zip(self.trackers, frames, timestamps):
            SEEN.append(int((depth == 0).all()))
            tr.process(gray, depth, ts)


def build(cfg, conf, device):
    return Each(cfg, conf, device)
'''
# an RGB-D camera whose depth ends at 3 m
SENSOR = '''
import numpy as np

from benchmark import scene

STREAMS = (("gray", np.uint8), ("depth", np.uint16))


def render(room, cfg, R, t):
    gray, depth = room.render(cfg.camera, R, t)
    depth = depth * (depth < 3.0)
    return scene.to_wire(gray, depth, cfg.tracking.depth_map_factor)


def blank(frame):
    gray, depth = frame
    return np.full_like(gray, 120), np.zeros_like(depth)
'''
METRIC = '''
SPANS = {"kf": "plslam_torch.models.tracking:Tracker._create_new_keyframe"}


def read(run):
    return len(run.spans.get("kf", [])) / max(run.host_frames, 1)
'''


def _digests(d: Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_additions_need_no_edit(tmp_path, small_size):
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench)

    # the new files: a system, a sensor, a configuration naming them, a
    # traffic mix with blackouts and a metric
    (bench / "systems" / "each_alone.py").write_text(SYSTEM)
    (bench / "sensors" / "rgbd_3m.py").write_text(SENSOR)
    conf = json.loads((bench / "configs" / "tum_fr3_rgbd.json").read_text())
    conf.update(name="pair_3m", system="each_alone", sensor="rgbd_3m", sessions=2, mapper="sync")
    (bench / "configs" / "pair_3m.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "explore.json").read_text())
    traffic["blackout"] = {"every": 4, "frames": 2}
    (bench / "traffic" / "blackouts.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "keyframes_per_frame.py").write_text(METRIC)
    # and their entries (BENCHMARK.json is the one file an addition appends to)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "pair_3m", "source": "x", "reduced": [], "why": "x",
                           "file": "benchmark/configs/pair_3m.json"})
    doc["workloads"].append({"name": "pair_3m.blackouts", "config": "pair_3m",
                             "traffic": "blackouts", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "keyframes_per_frame", "unit": "1", "better": "lower",
                             "source": "program_span", "layer": "tracker",
                             "moves": "frames_per_s"})

    spec = Spec(doc=doc, root=tmp_path, bench_dir=bench)
    per_layer = [m["name"] for m in spec.metrics("pair_3m.blackouts", "per_layer")]
    assert "keyframes_per_frame" in per_layer
    # a metric without a list of cells goes to every cell that reports what it moves
    assert "keyframes_per_frame" in [m["name"] for m in
                                     spec.metrics("tum_fr3_rgbd.explore", "per_layer")]
    e2e = [m["name"] for m in spec.metrics("pair_3m.blackouts", "end_to_end")]
    assert "frames_per_s" in e2e and "frame_latency_p90_ms" not in e2e

    out = run_cell(spec, "pair_3m.blackouts", 5, 4.0, True, time.perf_counter(),
                   device="cpu", tweak=small_size)
    seen = spec.system("each_alone").SEEN
    # both cameras stepped, the blacked-out frames among them
    assert out["attempted"] > 0 and len(seen) == 10 + out["attempted"]
    assert sum(seen) >= 2
    assert "keyframes_per_frame" in out["metrics"]
    assert set(out["checks"]) == set(conf["correct"]["limits"])
    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())


def test_every_named_file_exists():
    spec = Spec()
    for w in spec.doc["workloads"]:
        conf = spec.config(w["config"])
        spec.traffic(w["traffic"])
        assert callable(spec.system(conf["system"]).build)
        assert callable(spec.sensor(conf["sensor"]).render)
        numbers = set()
        for name in conf["correct"]["oracles"]:
            numbers |= set(spec.oracle(name).NUMBERS)
        assert numbers == set(conf["correct"]["limits"])
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics(w["name"], kind):
                assert callable(spec.reader(m["name"]).read)


def test_reader_labels_are_apart_from_the_correctness_captures():
    """A reader's recorded calls are the profiled slice's, not the frames
    that ``correct`` samples over the whole window."""
    spec = Spec()
    for m in spec.doc["per_layer"] + spec.doc["end_to_end"]:
        mod = spec.reader(m["name"])
        for table in ("SPANS", "SLICE_CALLS"):
            assert not any(label.startswith("correct.") for label in getattr(mod, table, {}))
