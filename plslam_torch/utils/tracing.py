"""Structured JSONL tracing of the frame loop (a copy of the JAX package's
``utils/tracing.py``, which imports nothing of JAX).

The reference's only instrumentation is a vector of per-frame tracking
times printed at exit (rgbd_tum.cc:141-149, rgbd_my.cpp:122-131). This is
the production replacement: one JSON line per retired frame (state,
match/inlier counters, map size, keyframe events, wall-time) plus arbitrary
subsystem events, append-only so a crashed run keeps its history.

Usage::

    tracer = Tracer("/tmp/run.jsonl")       # or Tracer(None) -> disabled
    System(cfg, trace_path="/tmp/run.jsonl")
"""

from __future__ import annotations

import json
import time


class Tracer:
    def __init__(self, path: str | None):
        self._f = open(path, "a", buffering=1) if path else None
        self._t0 = time.perf_counter()

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def emit(self, kind: str, **fields):
        if self._f is None:
            return
        rec = {"t": round(time.perf_counter() - self._t0, 6), "kind": kind}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


NULL = Tracer(None)
