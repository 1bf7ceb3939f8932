"""Host ms a sequence-frame in the matching of the tracker's motion,
local-map and rescue stages (the program's ``match`` spans), before the
profiled slice."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_frame(run, {"match"})
