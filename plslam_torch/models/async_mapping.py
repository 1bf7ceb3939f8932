"""Asynchronous local mapping: the reference's thread split at the host
level, the port of ``AsyncLocalMapper`` in
the JAX package's ``models/async_mapping.py``.

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

Unlike the JAX package, which prints a worker exception and carries on, the
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


class AsyncLocalMapper:
    """Wraps a LocalMapper with a worker thread and a keyframe queue."""

    def __init__(self, inner):
        self.inner = inner
        self.lock = inner.lock              # the mMutexMapUpdate equivalent
        self.error: BaseException | None = None
        self._q: queue.Queue = queue.Queue()
        # abort a running BA when another keyframe is waiting
        # (LocalMapping::InterruptBA, LocalMapping.cc:1107)
        inner.should_abort = lambda: not self._q.empty()
        self._pending = 0                   # keyframes queued or in process
        self._done = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # the LocalMapper interface the tracker uses ---------------------------
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

    def on_new_landmarks(self, kf, pt_ids, ln_ids):
        with self.lock:
            self.inner.on_new_landmarks(kf, pt_ids, ln_ids)

    def process_keyframe(self, kf: int):
        with self._done:
            self._pending += 1
        self._q.put(kf)

    # ----------------------------------------------------------------------
    def _run(self):
        while True:
            kf = self._q.get()
            if kf is None:  # shutdown
                return
            try:
                # the inner mapper takes the map lock per stage; holding it
                # across the whole pass (BA included) would stall the tracker
                self.inner.process_keyframe(kf)
            except Exception as e:
                _log.exception("local mapping failed on keyframe %d", kf)
                if self.error is None:
                    self.error = e
            finally:
                with self._done:
                    self._pending -= 1
                    self._done.notify_all()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Waits until every queued keyframe has been processed; False if
        ``timeout`` seconds passed first."""
        with self._done:
            return self._done.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self):
        """Stops the worker after the keyframes already queued; raises if it
        is still running 5 s later."""
        self._q.put(None)
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            raise RuntimeError("the local mapping thread did not stop within 5 s")
