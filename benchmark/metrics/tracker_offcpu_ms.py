"""Host ms a sequence-frame in which the tracker's thread was inside a frame
but off the CPU: the wall time of the program's root ``track.frame`` and
``multi.step`` spans less their thread's CPU time (waits for the interpreter
lock, the map lock and the device), before the profiled slice."""

from benchmark import program_spans


def read(run):
    roots = program_spans.spans(run, {"track.frame", "multi.step"})
    if roots is None or not run.host_frames:
        return None
    off = sum(s["end"] - s["start"] - s["cpu_s"] for s in roots if s["cpu_s"] is not None)
    return 1e3 * off / run.host_frames
