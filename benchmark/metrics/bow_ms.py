"""Host ms a sequence-frame in the bag-of-words transform (the program's
``bow.transform`` spans on every thread: each keyframe's, and each
relocalization's query), before the profiled slice; None where the program
records no such span."""

from benchmark import program_spans
from benchmark.program_spans_names import recorded


def read(run):
    return program_spans.ms_per_frame(run, {"bow.transform"}) if recorded("bow.transform") \
        else None
