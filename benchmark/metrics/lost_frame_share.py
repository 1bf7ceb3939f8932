"""Share (%) of the sequence-frames before the profiled slice that the
tracker handled in LOST or lost track on (the program's ``track.lost``
count); None where the program keeps no such count."""

from benchmark import program_spans
from benchmark.program_spans_names import recorded


def read(run):
    if not recorded("track.lost", kind="count") or not run.host_frames:
        return None
    return 100.0 * program_spans.count(run, "track.lost") / run.host_frames
