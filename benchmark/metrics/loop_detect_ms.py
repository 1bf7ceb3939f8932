"""Host ms a sequence-frame in the loop closer's passes over keyframes (the
program's ``loop.keyframe`` spans, on the closer's thread: detection, and a
relative-pose solve and correction where a loop is found), before the
profiled slice; None where the program records no such span. Detection
starts once the map holds 10 keyframes (LoopClosing.cc's
``KeyFramesInMap() < 10``); on a map below that, as the occlusion cell's
window is, this reads the gate's early return alone."""

from benchmark import program_spans
from benchmark.program_spans_names import recorded


def read(run):
    return program_spans.ms_per_frame(run, {"loop.keyframe"}) if recorded("loop.keyframe") \
        else None
