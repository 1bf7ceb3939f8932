"""Latency-oriented CPython GC policy for the frame loop.

A copy of the JAX package's ``utils/gctune.py`` (pure Python). The map's
observation bookkeeping keeps ~10^5 small long-lived dicts; a full (gen-2)
collection traverses all of them and can stall the frame loop at
unpredictable frames. The reference is C++ and has no collector at all —
the equivalent discipline here:

- ``gc.freeze()`` everything allocated up to engine construction (torch,
  numpy, loaded kernels) out of collector reach,
- raise the gen-0 threshold so transient per-frame allocation doesn't
  trigger frequent young collections mid-dispatch,
- make gen-2 collection EXPLICIT: never automatic (threshold 10^9), run
  it only at safe points (keyframe-rate maintenance, compaction,
  shutdown) via :func:`collect_old`.

Cyclic garbage accumulates slowly; the explicit gen-2 sweeps at safe
points bound it. Opt-in: ``System(tune_gc=True)`` and the file-driven
runner (``python -m plslam_torch.utils.run_tum``) apply it.
"""

from __future__ import annotations

import gc

_tuned = False
_saved_thresholds: tuple | None = None


def tune_gc():
    """Apply the latency policy (idempotent). PROCESS-GLOBAL: freezes every
    object alive at this call and disables automatic gen-2 collection —
    opt-in for that reason (System(tune_gc=True), the runner)."""
    global _tuned, _saved_thresholds
    if _tuned:
        return
    _tuned = True
    _saved_thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()
    # gen0 young-object burst cap; gen1 every 50 gen0 passes; gen2 never
    # automatically
    gc.set_threshold(50000, 50, 10**9)


def untune_gc():
    """Restore the interpreter's default GC policy (for embedders that
    outlive the engine): thresholds back, frozen objects returned to the
    collector, one full sweep to reclaim anything deferred."""
    global _tuned, _saved_thresholds
    if not _tuned:
        return
    _tuned = False
    gc.unfreeze()
    if _saved_thresholds is not None:
        gc.set_threshold(*_saved_thresholds)
        _saved_thresholds = None
    gc.collect()


def collect_old():
    """Explicit full collection — call only at safe points (no in-flight
    frames): compaction, shutdown, sequence boundaries."""
    gc.collect()


def is_tuned() -> bool:
    return _tuned
