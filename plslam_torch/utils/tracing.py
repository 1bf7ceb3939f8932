"""Structured JSONL tracing of the frame loop (a copy of the JAX package's
``utils/tracing.py``, which imports nothing of JAX), and the program's
in-memory recorder of spans and counts.

The reference's only instrumentation is a vector of per-frame tracking
times printed at exit (rgbd_tum.cc:141-149, rgbd_my.cpp:122-131). This is
the production replacement: one JSON line per retired frame (state,
match/inlier counters, map size, keyframe events, wall-time) plus arbitrary
subsystem events, append-only so a crashed run keeps its history.

Usage::

    tracer = Tracer("/tmp/run.jsonl")       # or Tracer(None) -> disabled
    System(cfg, trace_path="/tmp/run.jsonl")

**The recorder.** The tracker, the batched frontend and the local mapper
open named spans where their work happens (``span(name, **attrs)``, a
context manager) and count events (``count(name, n)``). One recorder
serves the process, off until ``enable()``. While it is off, ``span()`` returns the shared no-op
object ``NOOP`` and ``count()`` returns at once. While it is on, a span
records its name, attrs, start and end on ``time.perf_counter()``, its
thread and its parent (the innermost span open on the same thread); a root
span also records ``time.thread_time()`` at both ends, so that its wall time
less its thread's CPU time is the time the thread waited (the interpreter
lock, a map lock, the device). A span without a ``frame`` or ``session``
attr takes its parent's (``spans()`` resolves them). Counts are
time-stamped ``(t, n)`` pairs. At most ``capacity`` records are kept; the
rest are counted in ``dropped()``. ``System(trace_path=...)`` turns the
recorder on and writes what it recorded into the trace file at shutdown as
"span" and "count" records.

The names, and where they are opened:

- ``track.frame`` (root): ``Tracker.process``; ``multi.step`` (root, attrs
  ``step`` and ``batched``): ``MultiTracker.process``;
- ``sync.upload``: the frame's inputs copied to the device;
- ``track.perception``, ``track.motion``, ``track.rescue``, ``track.local``:
  the stages of ``fused_track_step``; ``match`` inside the last three: their
  matching; ``pose_lm``: ``optimize_pose``;
- ``sync.rescue``: the host reads of the rescue decision; counts
  ``track.rescue.rows`` (sequences sent to the rescue) and
  ``track.rescue.won`` (those it carried);
- ``track.finish`` (``frame``: the retired frame's id) with ``sync.retire``
  (its one host copy), ``track.keyframe`` and ``track.local_map``;
- ``lock.wait``: the tracker's map-lock acquisitions on the frame path;
- ``map.keyframe`` (attr ``kf``, ``frame``: the keyframe's frame): a local
  mapper's pass, with ``map.local_ba``;
- ``reloc``: ``relocalization.try_relocalize``, with ``reloc.query`` (the
  bag of words and the database query) and ``reloc.candidate`` (attrs
  ``kf`` and ``n_inliers``: one candidate's match, solve and pose LM);
  counts ``reloc.tries`` (calls), ``reloc.candidates`` (candidates tried)
  and ``reloc.won`` (relocalizations the tracker took); ``track.lost``
  counts the frames ``Tracker.process`` handles in LOST, and the frame on
  which tracking is lost;
- ``bow.transform``: ``Vocabulary.transform``; ``track.bow``: a keyframe's
  bag of words into the database (``Tracker._register_bow``);
- ``loop.keyframe`` (attr ``kf``): ``LoopCloser.process_keyframe``, with
  ``loop.detect``, ``loop.relative`` (one candidate's relative-pose solve)
  and ``loop.correct`` > ``loop.gba``; counts ``loop.candidates`` (the
  consistent candidates detected) and ``loop.closed``.

A span's ``set(**attrs)`` adds attrs known only once its work has run.
"""

from __future__ import annotations

import json
import threading
import time

# attrs a span takes from its parent when it has none of its own
INHERITED = ("frame", "session")


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

    def emit_recording(self):
        """Writes the recorder's spans and counts since this tracer opened
        as "span" records (``name``, ``start``, ``end``, ``thread``,
        ``parent``: the index of the parent's record or -1, ``attrs``, and
        ``cpu_s`` for a root span) and "count" records (``name``, ``at``,
        ``n``); times in seconds from the tracer's start, as ``t``."""
        if self._f is None:
            return
        t0 = self._t0
        kept = [s for s in RECORDER.spans() if s["start"] >= t0]
        index = {s["index"]: i for i, s in enumerate(kept)}
        for s in kept:
            fields = dict(name=s["name"], start=round(s["start"] - t0, 6),
                          end=round(s["end"] - t0, 6), thread=s["thread"],
                          parent=index.get(s["parent"], -1), attrs=s["attrs"])
            if s["cpu_s"] is not None:
                fields["cpu_s"] = round(s["cpu_s"], 6)
            self.emit("span", **fields)
        for name, events in RECORDER.counts().items():
            for at, n in events:
                if at >= t0:
                    self.emit("count", name=name, at=round(at - t0, 6), n=n)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


NULL = Tracer(None)


class _Noop:
    """What ``span()`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()

# a span's record: [name, attrs, start, end, thread, parent, cpu start, cpu end]
_NAME, _ATTRS, _START, _END, _THREAD, _PARENT, _CPU0, _CPU1 = range(8)


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_stack", "_r")

    def __init__(self, recorder, name, attrs):
        self._rec = recorder
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        t = time.perf_counter()
        rec = self._rec
        local = rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        self._stack = stack
        if stack:
            r = [self._name, self._attrs, t, None, threading.get_ident(), stack[-1], None, None]
        else:
            r = [self._name, self._attrs, t, None, threading.get_ident(), -1,
                 time.thread_time(), None]
        with rec._lock:
            if rec._n >= rec.capacity:
                rec._dropped += 1
                self._r = None
                return self
            i = len(rec._spans)
            rec._spans.append(r)
            rec._n += 1
        self._r = r
        stack.append(i)
        return self

    def __exit__(self, *exc):
        r = self._r
        if r is not None:
            if r[_CPU0] is not None:
                r[_CPU1] = time.thread_time()
            r[_END] = time.perf_counter()
            self._stack.pop()
        return False

    def set(self, **attrs):
        """Adds ``attrs`` to the span's record."""
        self._attrs.update(attrs)


class _Locked:
    """A lock whose acquisition is a ``lock.wait`` span."""

    __slots__ = ("_rec", "_lock")

    def __init__(self, recorder, lock):
        self._rec = recorder
        self._lock = lock

    def __enter__(self):
        with self._rec.span("lock.wait"):
            self._lock.__enter__()
        return self

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


class Recorder:
    """Spans and counts of one process (see the module docstring)."""

    def __init__(self, capacity: int = 1 << 18):
        self.capacity = capacity
        self._on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: list[list] = []
        self._counts: dict[str, list[tuple[float, int]]] = {}
        self._n = 0
        self._dropped = 0

    def enable(self):
        self._on = True

    def disable(self):
        self._on = False

    def enabled(self) -> bool:
        return self._on

    def reset(self):
        """Forgets every record. Spans still open finish into the old ones."""
        with self._lock:
            self._spans = []
            self._counts = {}
            self._n = 0
            self._dropped = 0
            self._local = threading.local()

    def span(self, name: str, **attrs):
        """A context manager that records one span while recording is on;
        the shared ``NOOP`` while it is off."""
        if not self._on:
            return NOOP
        return _Span(self, name, attrs)

    def count(self, name: str, n: int = 1):
        """Adds ``n`` to ``name``'s count, time-stamped."""
        if not self._on:
            return
        at = time.perf_counter()
        with self._lock:
            if self._n >= self.capacity:
                self._dropped += 1
                return
            self._counts.setdefault(name, []).append((at, int(n)))
            self._n += 1

    def locked(self, lock):
        """``lock`` itself while recording is off; while it is on, ``lock``
        with its acquisition recorded as a ``lock.wait`` span."""
        if not self._on:
            return lock
        return _Locked(self, lock)

    def dropped(self) -> int:
        """Records not kept: the capacity was reached."""
        return self._dropped

    def spans(self) -> list[dict]:
        """The finished spans in the order they opened: ``index``, ``name``,
        ``attrs`` (with ``frame`` and ``session`` taken from the parent where
        the span has none), ``start``, ``end``, ``thread``, ``parent`` (the
        parent's ``index``, -1 for a root) and ``cpu_s`` (the thread's CPU
        seconds over a root span; None for a child)."""
        with self._lock:
            recs = list(self._spans)
        resolved: list[dict] = []
        out = []
        for i, r in enumerate(recs):
            attrs = r[_ATTRS]
            p = r[_PARENT]
            if p >= 0:
                up = resolved[p]
                missing = [k for k in INHERITED if k in up and k not in attrs]
                if missing:
                    attrs = {**attrs, **{k: up[k] for k in missing}}
            resolved.append(attrs)
            if r[_END] is None:
                continue
            out.append({"index": i, "name": r[_NAME], "attrs": attrs, "start": r[_START],
                        "end": r[_END], "thread": r[_THREAD], "parent": p,
                        "cpu_s": None if r[_CPU0] is None else r[_CPU1] - r[_CPU0]})
        return out

    def counts(self) -> dict[str, list[tuple[float, int]]]:
        """Per name, the ``(t, n)`` events in the order they came."""
        with self._lock:
            return {k: list(v) for k, v in self._counts.items()}


RECORDER = Recorder()
enable = RECORDER.enable
disable = RECORDER.disable
enabled = RECORDER.enabled
reset = RECORDER.reset
span = RECORDER.span
count = RECORDER.count
locked = RECORDER.locked
spans = RECORDER.spans
counts = RECORDER.counts
dropped = RECORDER.dropped
