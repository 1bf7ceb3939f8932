"""Asynchronous local mapping and loop closing: the reference's thread
split at the host level, the port of ``AsyncLocalMapper`` and
``AsyncLoopCloser`` in the JAX package's ``models/async_mapping.py``.

The reference runs LocalMapping on its own thread consuming a keyframe
queue (LocalMapping.cc:72-164, System.cc:91), with Map::mMutexMapUpdate
serialising map edits against Tracking (Map.h:90, Tracking.cc:291). Here a
Python worker thread drains the keyframe queue and runs the mapping pass,
and the mapper's lock guards host map mutations on both sides.

Both threads enqueue their device work on the device's default stream (a
thread's current stream is the default one unless it sets another), so the
tracker's fused step and the mapper's in-place ``index_copy_`` into the
descriptor arenas run in the order they were enqueued, and that order is
the lock order.

The loop closer runs on a second worker (the reference's LoopClosing
thread, LoopClosing.cc:76-116): detection, the relative-pose solve,
correction and global BA run there while the tracker keeps retiring
frames; corrections reach the tracker through its gauge-correction
protocol, and a keyframe queued for the local mapper aborts a running
global BA between chunks (the mapper's ``should_abort``, mbStopGBA). A
correction holds an asynchronous mapper's ``pass_lock``, so no mapping pass
runs across it (the reference's CorrectLoop stops LocalMapping; the JAX package does
not, and a local BA gathered before a correction then writes the corrected
keyframes back where they were).

Unlike the JAX package, which prints a worker exception and carries on, a
worker stores the first exception in ``error`` and logs it; callers check
``error`` after ``shutdown``. Pending keyframes are counted under a
condition variable, queued or in process, so ``wait_idle`` cannot return
while one is still queued, and ``shutdown`` raises if the worker has not
stopped.
"""

from __future__ import annotations

import logging
import queue
import threading

_log = logging.getLogger(__name__)


class _KeyframeWorker:
    """A worker thread draining a keyframe queue into ``inner``."""

    _what = "worker"
    _stop_timeout = 5.0

    def __init__(self, inner):
        self.inner = inner
        self.lock = inner.lock              # the mMutexMapUpdate equivalent
        self.error: BaseException | None = None
        self._q: queue.Queue = queue.Queue()
        self._pending = 0                   # keyframes queued or in process
        self._done = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def process_keyframe(self, kf: int):
        with self._done:
            self._pending += 1
        self._q.put(kf)

    def _run(self):
        while True:
            kf = self._q.get()
            if kf is None:  # shutdown
                return
            try:
                # the inner pass takes the map lock per stage; holding it
                # across the whole pass (BA included) would stall the tracker
                self._process(kf)
            except Exception as e:
                _log.exception("%s failed on keyframe %d", self._what, kf)
                if self.error is None:
                    self.error = e
            finally:
                with self._done:
                    self._pending -= 1
                    self._done.notify_all()

    def _process(self, kf: int):
        self.inner.process_keyframe(kf)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Waits until every queued keyframe has been processed; False if
        ``timeout`` seconds passed first."""
        with self._done:
            return self._done.wait_for(lambda: self._pending == 0, timeout)

    @property
    def idle(self) -> bool:
        """No keyframe queued or in process."""
        with self._done:
            return self._pending == 0

    def shutdown(self):
        """Stops the worker after the keyframes already queued; raises if it
        has not stopped ``_stop_timeout`` seconds later."""
        self._q.put(None)
        self._thread.join(timeout=self._stop_timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"the {self._what} thread did not stop within "
                               f"{self._stop_timeout:g} s")


class AsyncLocalMapper(_KeyframeWorker):
    """Wraps a LocalMapper with a worker thread and a keyframe queue."""

    _what = "local mapping"

    def __init__(self, inner):
        # abort a running BA when another keyframe is waiting
        # (LocalMapping::InterruptBA, LocalMapping.cc:1107)
        inner.should_abort = lambda: not self._q.empty()
        # held for each keyframe pass; a loop correction takes it for its
        # whole length (CorrectLoop stops LocalMapping first), so no pass
        # reads poses before a correction and writes them back after it
        self.pass_lock = threading.Lock()
        super().__init__(inner)

    def _process(self, kf: int):
        with self.pass_lock:
            self.inner.process_keyframe(kf)

    # the LocalMapper interface the tracker and the loop closer use --------
    @property
    def enable_ba(self):
        return self.inner.enable_ba

    @enable_ba.setter
    def enable_ba(self, v):
        self.inner.enable_ba = v

    @property
    def recent_points(self):
        return self.inner.recent_points

    @property
    def recent_lines(self):
        return self.inner.recent_lines

    @property
    def should_abort(self):
        return self.inner.should_abort

    def on_new_landmarks(self, kf, pt_ids, ln_ids):
        with self.lock:
            self.inner.on_new_landmarks(kf, pt_ids, ln_ids)

    def fuse(self, kf: int):
        self.inner.fuse(kf)

    def run_local_ba(self, kf: int, window=None, **kw):
        return self.inner.run_local_ba(kf, window, **kw)

    def replace_point(self, loser, winner):
        with self.lock:
            self.inner.replace_point(loser, winner)


class AsyncLoopCloser(_KeyframeWorker):
    """Wraps a LoopCloser with a worker thread and a keyframe queue; its
    global BA aborts through the local mapper's ``should_abort``."""

    _what = "loop closing"
    _stop_timeout = 10.0  # a global BA may be mid-chunk

    def __init__(self, inner):
        # a correction pauses an asynchronous mapper's passes; a synchronous
        # mapper's pass runs whole under the map lock on the tracker's thread,
        # so it cannot straddle a stage of the correction
        inner.mapping_pause = getattr(getattr(inner, "local_mapper", None), "pass_lock", None)
        super().__init__(inner)

    # the LoopCloser interface ---------------------------------------------
    @property
    def n_loops_closed(self):
        return self.inner.n_loops_closed

    @property
    def last_loop_kf(self):
        return self.inner.last_loop_kf

    @property
    def last_loop_pair(self):
        return self.inner.last_loop_pair

    @property
    def enable_gba(self):
        return self.inner.enable_gba

    @enable_gba.setter
    def enable_gba(self, v):
        self.inner.enable_gba = v

    @property
    def tracker(self):
        return self.inner.tracker

    @tracker.setter
    def tracker(self, t):
        self.inner.tracker = t
