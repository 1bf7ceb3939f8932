"""Share (%) of the sequence-frames before the profiled slice that the
tracker sent to the rescue stage (the program's ``track.rescue.rows``
count)."""

from benchmark import program_spans


def read(run):
    rows = program_spans.count(run, "track.rescue.rows")
    return 100.0 * rows / run.host_frames if rows is not None and run.host_frames else None
