"""The program's own spans and counts (``plslam_torch.utils.tracing``) as the
per-layer readers see them.

Importing this module turns the program's recorder on, from a fresh start.
The harness loads per-layer readers only in a ``--trace 1`` run, so the runs
that decide the end-to-end metrics record nothing. A program whose tracing
module has no recorder gives the readers nothing to read: they return None.

Spans and counts are taken as ``Run.span_s`` takes the harness's wrappers:
those that started in the window before the profiled slice,
``[run.t_window[0], run.t_host_end)``, a sequence-frame being one of
``run.host_frames``. Every time is on ``time.perf_counter()``, the clock of
the harness's window and of the marker that ties the device trace to the host
(``host_at_zero_s``).
"""

from __future__ import annotations

import bisect

from plslam_torch.utils import tracing

RECORDING = all(hasattr(tracing, f) for f in ("enable", "reset", "spans", "counts"))
if RECORDING:
    tracing.reset()
    tracing.enable()


def spans(run, names) -> list[dict] | None:
    """The finished spans named in ``names`` that started in the window
    before the slice; None without a recorder."""
    if not RECORDING:
        return None
    lo, hi = run.t_window[0], run.t_host_end
    return [s for s in tracing.spans() if s["name"] in names and lo <= s["start"] < hi]


def ms_per_frame(run, names) -> float | None:
    """Host ms a sequence-frame in the spans named in ``names``."""
    got = spans(run, names)
    if got is None or not run.host_frames:
        return None
    return 1e3 * sum(s["end"] - s["start"] for s in got) / run.host_frames


def count(run, name: str) -> int | None:
    """The sum of ``name``'s counts stamped in the window before the slice."""
    if not RECORDING:
        return None
    lo, hi = run.t_window[0], run.t_host_end
    return sum(n for t, n in tracing.counts().get(name, []) if lo <= t < hi)


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def self_s(run, name: str) -> float | None:
    """Seconds in ``name``'s spans (started in the window before the slice)
    that none of their child spans covers."""
    if not RECORDING:
        return None
    every = tracing.spans()
    kids: dict[int, list] = {}
    for s in every:
        kids.setdefault(s["parent"], []).append((s["start"], s["end"]))
    total = 0.0
    for s in spans(run, {name}):
        covered = sum(min(e, s["end"]) - max(b, s["start"])
                      for b, e in union(kids.get(s["index"], [])))
        total += s["end"] - s["start"] - covered
    return total


def slice_kernels_in(run, name: str) -> int | None:
    """Kernels of the profiled slice whose start, on the host's clock, lies
    inside one of ``name``'s spans; None without the trace's tie to the host
    clock or without a recorder."""
    sl = run.slice
    if not RECORDING or not sl or not sl["kernels"] or sl.get("host_at_zero_s") is None:
        return None
    t0, t1 = sl["t0"], sl["t1"]
    iv = union((s["start"], s["end"]) for s in tracing.spans()
               if s["name"] == name and s["end"] >= t0 and s["start"] <= t1)
    starts = [s for s, _ in iv]
    n = 0
    for _, k0, _ in sl["kernels"]:
        at = sl["host_at_zero_s"] + k0 / 1e6
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= iv[i][1]:
            n += 1
    return n
