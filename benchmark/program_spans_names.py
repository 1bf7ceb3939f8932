"""Whether the program records a span or count name at all: the readers of
metrics that only a newer program records return None on one that records
no such name, rather than reading zero.

A name counts as recorded once the recorder holds one record of it from any
time of the run (warm-up, window or profiled slice), so a window that
happens to hold none still reads zero where the program has the name."""

from plslam_torch.utils import tracing

from benchmark import program_spans


def recorded(name: str, kind: str = "span") -> bool:
    if not program_spans.RECORDING:
        return False
    if kind == "count":
        return name in tracing.counts()
    return any(s["name"] == name for s in tracing.spans())
