"""Host ms a sequence-frame in relocalization (the program's ``reloc``
spans: the bag of words, the database query and the candidate tries),
before the profiled slice; None where the program records no ``reloc``
span."""

from benchmark import program_spans
from benchmark.program_spans_names import recorded


def read(run):
    return program_spans.ms_per_frame(run, {"reloc"}) if recorded("reloc") else None
