"""plslam_torch Tracker with local mapping against the JAX package's.

1. Sixteen 320x240 frames of a fast orbit (100 frames a turn) through
   ``Tracker.process`` with a synchronous ``LocalMapper`` in both packages,
   the JAX side's local BA in float64 as the port solves
   (``torch_parity.jax_ba_in_float64``). The third keyframe comes at frame
   9 and its local BA runs in both packages; every frame tracks, the
   keyframe counts and BA runs are equal, and per-frame poses agree within
   5 mm as tracked and as healed (the gap comes from the frontend's LSD
   divergence, ROADMAP.md Queue C, which changes the BA problem's line
   set; the port's BA solves the JAX problem to the JAX result).
2. The port's ``AsyncLocalMapper`` on the CPU: the worker processes every
   keyframe, ``error`` stays None, the trajectory heals against moved
   keyframes, a failing mapper pass is stored in ``error`` instead of being
   swallowed, ``wait_idle`` returns only once every queued keyframe is
   done, and ``shutdown`` raises when the worker does not stop.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from plslam_tpu.config import SlamConfig as JSlamConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.models import tracking as jtracking
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plslam_tpu.models.map import SlamMap as JSlamMap
from plslam_tpu.optim import local_ba as jlocal_ba
from plslam_torch import convert
from plslam_torch.models import tracking as ttracking
from plslam_torch.models.async_mapping import AsyncLocalMapper
from plslam_torch.models.local_mapping import LocalMapper
from plslam_torch.models.map import SlamMap
from plslam_torch.optim import local_ba
from torch_parity import KW, jax_ba_in_float64, render
from torch_parity import few_torch_threads  # noqa: F401

N_FRAMES = 16


@pytest.fixture(scope="module")
def frames():
    return render(N_FRAMES, total=100)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = JSlamConfig(camera=JCamera(**KW))
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _centers(traj):
    return np.array([-(R.T @ t) for _, R, t in traj])


def test_sequence_with_local_mapper(frames, cfgs):
    jcfg, cfg = cfgs
    jm = JSlamMap(jcfg)
    jt = jtracking.Tracker(jcfg, jm, local_mapper=JLocalMapper(jcfg, jm))
    m = SlamMap(cfg, device="cpu")
    mapper = LocalMapper(cfg, m)
    tr = ttracking.Tracker(cfg, m, local_mapper=mapper)
    ba_frames = {"jax": [], "port": []}
    frame = [0]
    with jax_ba_in_float64():
        jba = jlocal_ba.bundle_adjust_stepped

        def counted(*args, **kw):
            ba_frames["jax"].append(frame[0])
            return jba(*args, **kw)

        jlocal_ba.bundle_adjust_stepped = counted
        try:
            for i, (g, d) in enumerate(frames):
                frame[0] = i
                jt.process(g, d, i / 30.0)
                runs = local_ba.bundle_adjust_stepped.runs
                tr.process(g, d, i / 30.0)
                ba_frames["port"] += [i] * (local_ba.bundle_adjust_stepped.runs - runs)
                assert tr.state == ttracking.OK, i
            jt.flush()
            tr.flush()
        finally:
            jlocal_ba.bundle_adjust_stepped = jba
    assert len(tr.trajectory) == len(jt.trajectory) == N_FRAMES
    assert m.n_kf == jm.n_kf >= 3
    assert ba_frames["port"] == ba_frames["jax"] and len(ba_frames["port"]) >= 1
    assert ba_frames["port"][0] < N_FRAMES - 3  # frames tracked on the BA-moved map
    assert mapper.fuse_passes == m.n_kf  # every keyframe went through the mapper
    assert abs(m.n_points() - jm.n_points()) <= 0.02 * jm.n_points()
    err = np.linalg.norm(_centers(tr.trajectory) - _centers(jt.trajectory), axis=1)
    assert err.max() < 5e-3, err
    # the spanning tree grew as in the JAX package
    np.testing.assert_array_equal(m.kf_parent[:m.n_kf], jm.kf_parent[:jm.n_kf])
    healed = _centers(tr.healed_trajectory())
    assert np.linalg.norm(healed - _centers(jt.healed_trajectory()), axis=1).max() < 5e-3


def test_async_mapper_on_cpu(frames, cfgs):
    _, cfg = cfgs
    m = SlamMap(cfg, device="cpu")
    mapper = AsyncLocalMapper(LocalMapper(cfg, m))
    tr = ttracking.Tracker(cfg, m, local_mapper=mapper)
    assert tr._map_lock is mapper.lock
    for i, (g, d) in enumerate(frames):
        tr.process(g, d, i / 30.0)
        assert tr.state == ttracking.OK, i
    tr.flush()
    mapper.wait_idle()
    mapper.shutdown()
    assert mapper.error is None
    assert mapper.inner.fuse_passes == m.n_kf >= 2
    assert len(tr.trajectory) == len(tr.traj_refs) == N_FRAMES
    # a keyframe-spawning frame references its own keyframe at identity
    kf_frames = set(m.kf_frame_id[:m.n_kf].tolist())
    for i, (ref, Rcr, tcr) in enumerate(tr.traj_refs):
        if i in kf_frames and i > 0:
            assert m.kf_frame_id[ref] == i
            np.testing.assert_array_equal(Rcr, np.eye(3, dtype=np.float32))
    # healing: shift every keyframe 10 cm in the world, and the healed
    # trajectory follows while the as-tracked one stays
    healed0 = _centers(tr.healed_trajectory())
    shift = np.array([0.0, 0.1, 0.0], np.float32)
    for k in range(m.n_kf):
        m.kf_t[k] = m.kf_t[k] - m.kf_R[k] @ shift
    moved = _centers(tr.healed_trajectory())
    np.testing.assert_allclose(moved - healed0, np.tile(shift, (N_FRAMES, 1)), atol=1e-5)
    np.testing.assert_array_equal(_centers(tr.trajectory)[0], np.zeros(3))


def test_async_mapper_stores_a_failure(cfgs):
    _, cfg = cfgs
    m = SlamMap(cfg, device="cpu")
    inner = LocalMapper(cfg, m)

    def fail(kf):
        raise RuntimeError(f"boom at {kf}")

    inner.process_keyframe = fail
    mapper = AsyncLocalMapper(inner)
    mapper.process_keyframe(3)
    mapper.process_keyframe(4)
    mapper.wait_idle(10.0)
    mapper.shutdown()
    assert isinstance(mapper.error, RuntimeError) and "boom at 3" in str(mapper.error)


class _SlowInner:
    """A stand-in LocalMapper whose pass takes ``delay`` seconds, or blocks
    until ``release`` is set."""

    def __init__(self, delay=0.0):
        self.lock = threading.RLock()
        self.should_abort = None
        self.delay = delay
        self.release = threading.Event()
        self.done = []

    def process_keyframe(self, kf):
        if self.delay:
            time.sleep(self.delay)
        else:
            self.release.wait()
        self.done.append(kf)


def test_async_mapper_wait_idle_waits_for_every_keyframe():
    inner = _SlowInner(delay=0.05)
    mapper = AsyncLocalMapper(inner)
    for kf in range(6):
        mapper.process_keyframe(kf)
        if kf == 2:  # the worker has just finished one while others queue
            time.sleep(0.06)
    assert inner.should_abort()  # keyframes are waiting: a running BA aborts
    assert mapper.wait_idle(10.0)
    assert inner.done == list(range(6))
    assert not inner.should_abort()
    mapper.shutdown()
    assert not mapper._thread.is_alive() and mapper.error is None


def test_async_mapper_shutdown_raises_on_a_hung_worker():
    inner = _SlowInner()
    mapper = AsyncLocalMapper(inner)
    mapper.process_keyframe(0)
    assert not mapper.wait_idle(0.1)
    with pytest.raises(RuntimeError, match="did not stop"):
        mapper.shutdown()
    inner.release.set()
    assert mapper.wait_idle(10.0)
    mapper.shutdown()
