"""System facade: owns the map, all pipeline passes, and the savers.

The port of the JAX package's ``models/system.py``, the equivalent of
``ORB_SLAM2::System`` (System.h, System.cc): construction wires vocabulary
→ keyframe database → map → tracking / local-mapping / loop-closing /
dense-cloud passes (the reference launches std::threads, System.cc:86-118;
here the passes run in the frame loop, or on the two worker threads of
models.async_mapping with ``async_mapping=True``), ``track_rgbd`` is the
per-frame entry (TrackRGBD, :175-230; ``track_stereo`` and
``track_monocular`` for the other sensors, :121-174 and :236-280), and the
savers emit TUM / KITTI trajectories and a PCD cloud (:337-487, :507) byte
for byte as the JAX package writes them. A monocular System estimates
loop corrections as Sim(3) (``fix_scale=False``). Every device tensor
lives on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..bow.database import KeyFrameDatabase
from ..bow.vocabulary import Vocabulary, load_dbow2_text
from ..config import SlamConfig
from ..utils import checkpoint, gctune, tum_io
from ..utils.tracing import Tracer
from .async_mapping import AsyncLocalMapper, AsyncLoopCloser
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map import SlamMap
from .pointcloud import PointCloudMapper
from .tracking import LOST, OK, SENSORS, Tracker

_DEFAULT_VOCAB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bow", "vocab_synth.npz",
)


class System:
    def __init__(self, cfg: SlamConfig, vocabulary_path: str | None = None,
                 enable_loop_closing: bool = True,
                 enable_dense_cloud: bool = False,
                 localization_only: bool = False,
                 async_mapping: bool = False,
                 sensor: str = "rgbd",
                 trace_path: str | None = None,
                 tune_gc: bool = False,
                 device="cuda"):
        if sensor not in SENSORS:
            raise ValueError(f"sensor={sensor!r}: one of {SENSORS}")
        if sensor == "mono" and cfg.loop.fix_scale:
            # monocular scale is unobservable: loop corrections estimate a
            # full Sim(3) and the essential graph runs 7-dof so that scale
            # drift can be absorbed (mbFixScale = sensor != MONOCULAR,
            # LoopClosing.cc:37-43; Optimizer.cc:1135)
            cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, fix_scale=False))
        if tune_gc:
            # keep CPython's gen-2 collector out of the frame loop; explicit
            # sweeps run at compaction / shutdown instead (utils.gctune).
            # PROCESS-GLOBAL, hence opt-in
            gctune.tune_gc()
        self.cfg = cfg
        self.sensor = sensor  # System eSensor (System.h:58-66)
        self.tracer = Tracer(trace_path)
        vocab_path = vocabulary_path or _DEFAULT_VOCAB
        if vocab_path.endswith(".txt"):
            self.voc = load_dbow2_text(vocab_path, device=device)
        else:
            self.voc = Vocabulary.load(vocab_path, device=device)
        self.kfdb = KeyFrameDatabase(self.voc, cfg.capacity.max_keyframes)
        self.map = SlamMap(cfg, device=device)
        self.local_mapper = LocalMapper(cfg, self.map, enable_ba=not localization_only,
                                        kfdb=self.kfdb)
        if async_mapping:
            self.local_mapper = AsyncLocalMapper(self.local_mapper)
        self.loop_closer = (
            LoopCloser(cfg, self.map, self.kfdb, self.voc, self.local_mapper)
            if enable_loop_closing else None
        )
        if async_mapping and self.loop_closer is not None:
            self.loop_closer = AsyncLoopCloser(self.loop_closer)
        self.tracker = Tracker(cfg, self.map, local_mapper=self.local_mapper,
                               loop_closer=self.loop_closer, voc=self.voc,
                               kfdb=self.kfdb, sensor=sensor, tracer=self.tracer)
        if self.loop_closer is not None:
            self.loop_closer.tracker = self.tracker
        self.cloud = PointCloudMapper(cfg, device=device) if enable_dense_cloud else None
        self.localization_only = localization_only
        if localization_only:
            self.tracker.only_tracking = True
        self._last_n_kf = 0
        self._last_cloud_change = 0
        self._last_big_change = 0

    # ------------------------------------------------------------------ API
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        """Track one RGB-D frame; returns (R, t) world-to-camera or None
        (lag-1 pipelined: the previous frame's pose). ``depth`` in metres
        (apply DepthMapFactor upstream, Tracking.cc:228)."""
        out = self.tracker.process(gray, depth, timestamp)
        if self.cloud is not None:
            if self.map.n_kf != self._last_n_kf:
                kf = self.map.n_kf - 1
                self.cloud.insert_keyframe(kf, gray, depth, self.map.kf_R[kf],
                                           self.map.kf_t[kf])
                self._last_n_kf = self.map.n_kf
            # a loop correction / GBA moved the gauge: schedule a rebuild
            # from the corrected keyframe poses (the reference's is_loop_
            # rebuild, PointCloudMapping.cc:168-176), the poses snapshotted
            # under the map lock, the re-accumulation spread over frames
            if self.map.big_change_idx != self._last_cloud_change:
                with self.tracker._map_lock:
                    self.cloud.mark_dirty(self.map)
                self._last_cloud_change = self.map.big_change_idx
            self.cloud.step()
        return out

    def track_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray, timestamp: float):
        """Track one rectified stereo pair (System::TrackStereo,
        System.cc:121-174); RuntimeError unless the sensor is stereo."""
        return self.tracker.process_stereo(gray_l, gray_r, timestamp)

    def track_monocular(self, gray: np.ndarray, timestamp: float):
        """Track one monocular frame (System::TrackMonocular,
        System.cc:236-280); returns (R, t) up to the bootstrap's scale.
        RuntimeError unless the sensor is mono."""
        return self.tracker.process_mono(gray, timestamp)

    def activate_localization_mode(self):
        """ActivateLocalizationMode (System.cc:129-140): freeze mapping."""
        self.local_mapper.enable_ba = False
        self.localization_only = True
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.local_mapper.enable_ba = True
        self.localization_only = False
        self.tracker.only_tracking = False

    def reset(self):
        self.tracker.reset()

    def shutdown(self):
        """Drain the tracking pipeline and join the async mapping and
        loop-closing workers (System::Shutdown, System.cc:313-335)."""
        self.tracker.flush()
        lm, lc = self.local_mapper, self.loop_closer
        if isinstance(lm, AsyncLocalMapper):
            lm.wait_idle(timeout=30.0)
        if isinstance(lc, AsyncLoopCloser):
            lc.wait_idle(timeout=60.0)
            lc.shutdown()
        if isinstance(lm, AsyncLocalMapper):
            lm.wait_idle(timeout=30.0)
            lm.shutdown()
        self.tracer.close()
        if gctune.is_tuned():
            gctune.collect_old()  # safe point: nothing in flight

    def compact_map(self):
        """Reclaim erased landmark arena slots (unbounded-run support).
        Drains the tracking pipeline and the workers, then, under the map
        lock, compacts the map, remaps the tracker's and the mapper's
        landmark ids and rebuilds the tracker's local map (its slot tables
        refer to the old ids)."""
        tr = self.tracker
        if not self._quiesce():
            raise RuntimeError("compact_map: a worker did not go idle")
        with tr._map_lock:
            pt_map, ln_map = self.map.compact()

            def remap(ids, table):
                return None if ids is None else np.where(ids >= 0, table[np.clip(ids, 0, None)],
                                                         -1).astype(np.int32)

            tr.last_pt_ids = remap(tr.last_pt_ids, pt_map)
            tr.last_ln_ids = remap(tr.last_ln_ids, ln_map)
            base = getattr(self.local_mapper, "inner", self.local_mapper)
            base.recent_points = [(int(pt_map[p]), born) for p, born in base.recent_points
                                  if pt_map[p] >= 0]
            base.recent_lines = [(int(ln_map[l]), born) for l, born in base.recent_lines
                                 if ln_map[l] >= 0]
            if tr.state == OK and tr.last_pt_ids is not None:
                tr._refresh_local_map(tr.last_pt_ids, tr.last_ln_ids)
            else:
                # no local map until the tracker rebinds one (relocalization
                # or initialization rebuild it from scratch)
                tr._lp_ids = np.zeros(0, np.int32)
                tr._ll_ids = np.zeros(0, np.int32)
                tr._lm_args = None
        if gctune.is_tuned():
            gctune.collect_old()  # safe point: pipeline drained above

    def save_map(self, path: str):
        """Persist the world model (no reference analogue — ORB-SLAM2
        cannot save maps; see utils.checkpoint)."""
        self._quiesce()
        checkpoint.save_map(self.map, path)

    def load_map(self, path: str):
        """Restore a saved map (of either package) and re-register its
        keyframes with the BoW database. The tracker starts LOST and
        relocalizes into the map — pair with localization_only=True for pure
        localization."""
        self._quiesce()
        new_map = checkpoint.load_map(self.cfg, path, device=self.map.device)
        with self.tracker._map_lock:
            self.map.__dict__.update(new_map.__dict__)
        checkpoint.register_keyframes(self)
        self.tracker.state = LOST
        self.tracker.n_lost_frames = 0
        # no motion prior into a freshly loaded map: the short-lost reloc
        # gate must not compare against a stale pre-load pose
        self.tracker.last_pose = None

    def map_changed(self) -> bool:
        """System::MapChanged (System.cc:294-305)."""
        idx = self.map.big_change_idx
        changed = idx > self._last_big_change
        self._last_big_change = idx
        return changed

    @property
    def tracking_state(self) -> int:
        return self.tracker.state

    # ---------------------------------------------------------------- savers
    def _quiesce(self) -> bool:
        """Drain in-flight frames and let the async workers finish their
        queues, so that savers see a settled map. False when a worker did
        not go idle within its timeout."""
        self.tracker.flush()
        idle = True
        for w in (self.local_mapper, self.loop_closer):
            if isinstance(w, (AsyncLocalMapper, AsyncLoopCloser)):
                idle = w.wait_idle(timeout=60.0) and idle
        return idle

    def save_trajectory_tum(self, path: str):
        """Frame trajectory in TUM format (SaveTrajectoryTUM,
        System.cc:337-396). Poses are HEALED: each frame is re-composed
        against the current pose of its reference keyframe, so loop
        closures / GBA retroactively correct the whole trajectory."""
        self._quiesce()
        traj = self.tracker.healed_trajectory()
        tum_io.save_trajectory_tum(path, [ts for ts, _, _ in traj],
                                   [se3_inv_np(R, t) for _, R, t in traj])

    def save_keyframe_trajectory_tum(self, path: str):
        """SaveKeyFrameTrajectoryTUM (System.cc:398-441)."""
        m = self.map
        kfs = [k for k in range(m.n_kf) if m.kf_valid[k]]
        tum_io.save_trajectory_tum(path, [m.kf_timestamp[k] for k in kfs],
                                   [se3_inv_np(m.kf_R[k], m.kf_t[k]) for k in kfs])

    def save_trajectory_kitti(self, path: str):
        """SaveTrajectoryKITTI (System.cc:443-487), healed like the TUM
        saver."""
        self._quiesce()
        tum_io.save_trajectory_kitti(
            path, [se3_inv_np(R, t) for _, R, t in self.tracker.healed_trajectory()])

    def save_pcd(self, path: str):
        if self.cloud is not None:
            self._quiesce()
            if self.map.big_change_idx != self._last_cloud_change:
                with self.tracker._map_lock:
                    self.cloud.mark_dirty(self.map)
                self._last_cloud_change = self.map.big_change_idx
            self.cloud.drain()
            self.cloud.save_pcd(path)


def se3_inv_np(R: np.ndarray, t: np.ndarray):
    """Tcw -> Twc as numpy (the savers emit camera-to-world)."""
    Rwc = R.T
    return Rwc, -Rwc @ t
