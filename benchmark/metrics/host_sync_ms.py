"""Host ms a sequence-frame in the tracker's waits on the device: the
inputs' upload, the rescue decision's host reads and the retirement's host
copy (the program's ``sync.upload``, ``sync.rescue`` and ``sync.retire``
spans), before the profiled slice."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_frame(run, {"sync.upload", "sync.rescue", "sync.retire"})
