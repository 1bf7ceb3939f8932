"""Host ms a sequence-frame in the local mappers' local BA (the program's
``map.local_ba`` spans, on whichever thread the mapper runs), before the
profiled slice."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_frame(run, {"map.local_ba"})
