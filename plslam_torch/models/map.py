"""World model: keyframe / map-point / map-line arenas.

The reference's pointer-graph map (``Map``, ``KeyFrame``, ``MapPoint``,
``MapLine`` — Map.cc, KeyFrame.cc, MapPoint.cc, MapLine.cpp) as
struct-of-arrays arenas, as in the JAX package:

- keyframes are rows in pose/feature arrays (feature snapshots are host
  numpy ``HostFrame`` mirrors of the per-frame ``FrameData``),
- landmarks live in fixed-capacity arenas with monotonic allocation,
- observations are per-keyframe match arrays ``kf_pt_idx[kf, feat] ->
  point_id`` plus python obs dicts,
- covisibility weights are recomputed from observation joins
  (KeyFrame::UpdateConnections semantics, KeyFrame.cc:363-452).

The bookkeeping is host numpy. The descriptor arenas — what the matching
kernels read — are ``uint8`` tensors on the map's device, updated in place
with ``index_copy_``: landmark rows are copied straight from a keyframe's
device FrameData, and host-authored rows are staged dirty and flushed on
the first read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig


class HostFrame:
    """Numpy mirror of a FrameData (keyframe feature snapshot)."""

    __slots__ = (
        "kp_xy", "kp_xy_un", "kp_resp", "kp_octave", "kp_angle", "kp_desc",
        "kp_depth", "kp_ur", "kp_valid",
        "ln_ep", "ln_ep_un", "ln_angle", "ln_length", "ln_coeff", "ln_desc",
        "ln_depth", "ln_valid",
    )

    def __init__(self, fd):
        for k in self.__slots__:
            v = getattr(fd, k)
            setattr(self, k, v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))


class SlamMap:
    """Global map arenas + keyframe registry."""

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        cap = cfg.capacity
        n_kp = cfg.orb.max_keypoints
        n_ln = cfg.lines.max_lines

        # keyframes
        self.kf_R = np.zeros((cap.max_keyframes, 3, 3), np.float32)
        self.kf_t = np.zeros((cap.max_keyframes, 3), np.float32)
        self.kf_valid = np.zeros(cap.max_keyframes, bool)
        self.kf_frame_id = np.full(cap.max_keyframes, -1, np.int64)
        self.kf_timestamp = np.zeros(cap.max_keyframes, np.float64)
        self.kf_frames: list[HostFrame | None] = [None] * cap.max_keyframes
        self.kf_frames_dev: list = [None] * cap.max_keyframes
        self.kf_pt_idx = np.full((cap.max_keyframes, n_kp), -1, np.int32)
        self.kf_ln_idx = np.full((cap.max_keyframes, n_ln), -1, np.int32)
        # spanning tree (KeyFrame::mpParent/mspChildrens), attached by local
        # mapping; the local-map harvest walks it
        self.kf_parent = np.full(cap.max_keyframes, -1, np.int32)
        self.kf_children: list[set[int]] = [set() for _ in range(cap.max_keyframes)]
        self.n_kf = 0

        # map points
        self.pt_pos = np.zeros((cap.max_points, 3), np.float32)
        self.pt_desc = np.zeros((cap.max_points, 32), np.uint8)
        self.pt_normal = np.zeros((cap.max_points, 3), np.float32)
        self.pt_min_dist = np.zeros(cap.max_points, np.float32)
        self.pt_max_dist = np.zeros(cap.max_points, np.float32)
        self.pt_valid = np.zeros(cap.max_points, bool)
        self.pt_first_kf = np.full(cap.max_points, -1, np.int32)
        self.pt_visible = np.zeros(cap.max_points, np.int32)
        self.pt_found = np.zeros(cap.max_points, np.int32)
        self.pt_obs: list[dict[int, int]] = [dict() for _ in range(cap.max_points)]
        # Monotonic allocation: the tracker's device-resident local map holds
        # ids between refreshes, and a recycled id would silently rebind its
        # matches to an unrelated new landmark.
        self._pt_next = 0

        # map lines (endpoint representation; Plücker derived on the fly)
        self.ln_ep = np.zeros((cap.max_lines, 2, 3), np.float32)
        self.ln_desc = np.zeros((cap.max_lines, 72), np.uint8)
        self.ln_valid = np.zeros(cap.max_lines, bool)
        self.ln_first_kf = np.full(cap.max_lines, -1, np.int32)
        self.ln_visible = np.zeros(cap.max_lines, np.int32)
        self.ln_found = np.zeros(cap.max_lines, np.int32)
        self.ln_normal = np.zeros((cap.max_lines, 3), np.float32)
        self.ln_min_dist = np.zeros(cap.max_lines, np.float32)
        self.ln_max_dist = np.zeros(cap.max_lines, np.float32)
        self.ln_obs: list[dict[int, int]] = [dict() for _ in range(cap.max_lines)]
        self._ln_next = 0

        # device descriptor arenas (allocated on first use)
        self._pt_desc_dev: torch.Tensor | None = None
        self._pt_desc_dirty: list[int] = []
        self._ln_desc_dev: torch.Tensor | None = None
        self._ln_desc_dirty: list[int] = []

    # ---------------------------------------------------- descriptor arenas
    def _flush(self, arena, dirty, host_rows) -> torch.Tensor:
        if arena is None:
            arena = torch.zeros(host_rows.shape, dtype=torch.uint8, device=self.device)
        if dirty:
            ids = np.array(sorted(set(dirty)), np.int64)
            arena.index_copy_(0, torch.as_tensor(ids, device=self.device),
                              torch.as_tensor(host_rows[ids], device=self.device))
            dirty.clear()
        return arena

    def point_desc_arena(self) -> torch.Tensor:
        """(max_points, 32) uint8 device tensor, host-dirty rows flushed."""
        self._pt_desc_dev = self._flush(self._pt_desc_dev, self._pt_desc_dirty,
                                        self.pt_desc)
        return self._pt_desc_dev

    def line_desc_arena(self) -> torch.Tensor:
        self._ln_desc_dev = self._flush(self._ln_desc_dev, self._ln_desc_dirty,
                                        self.ln_desc)
        return self._ln_desc_dev

    def _scatter_from(self, arena, src_desc_dev, feats, ids):
        if len(ids) == 0:
            return
        f = torch.as_tensor(np.asarray(feats, np.int64), device=self.device)
        i = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        arena.index_copy_(0, i, src_desc_dev.index_select(0, f))

    def scatter_point_descs_from(self, src_desc_dev, feats, pids):
        """arena[pids] = src[feats], entirely on device (keyframe creation:
        ``src_desc_dev`` is the new keyframe's fd.kp_desc)."""
        self._scatter_from(self.point_desc_arena(), src_desc_dev, feats, pids)

    def scatter_line_descs_from(self, src_desc_dev, feats, lids):
        self._scatter_from(self.line_desc_arena(), src_desc_dev, feats, lids)

    # ---------------------------------------------------------------- points
    def add_point(self, pos, desc, normal, min_d, max_d, first_kf) -> int:
        """``desc=None`` means device-managed: the caller scatters the row
        into the device arena itself (scatter_point_descs_from)."""
        pid = self._pt_next
        if pid >= self.pt_pos.shape[0]:
            raise RuntimeError("point arena full — compaction needed")
        self._pt_next += 1
        self.pt_pos[pid] = pos
        if desc is not None:
            self.pt_desc[pid] = desc
            self._pt_desc_dirty.append(pid)
        self.pt_normal[pid] = normal
        self.pt_min_dist[pid] = min_d
        self.pt_max_dist[pid] = max_d
        self.pt_valid[pid] = True
        self.pt_first_kf[pid] = first_kf
        self.pt_visible[pid] = 1
        self.pt_found[pid] = 1
        self.pt_obs[pid].clear()
        return pid

    def add_point_obs(self, pid: int, kf: int, feat: int):
        # a landmark observes a keyframe at ONE feature (MapPoint::
        # AddObservation upsert): re-binding clears the previous slot
        prev = self.pt_obs[pid].get(kf)
        if prev is not None and prev != feat and self.kf_pt_idx[kf, prev] == pid:
            self.kf_pt_idx[kf, prev] = -1
        self.pt_obs[pid][kf] = feat
        self.kf_pt_idx[kf, feat] = pid

    # ----------------------------------------------------------------- lines
    def add_line(self, ep, desc, first_kf) -> int:
        """``desc=None`` means device-managed (scatter_line_descs_from)."""
        lid = self._ln_next
        if lid >= self.ln_ep.shape[0]:
            raise RuntimeError("line arena full — compaction needed")
        self._ln_next += 1
        self.ln_ep[lid] = ep
        if desc is not None:
            self.ln_desc[lid] = desc
            self._ln_desc_dirty.append(lid)
        self.ln_valid[lid] = True
        self.ln_first_kf[lid] = first_kf
        self.ln_visible[lid] = 1
        self.ln_found[lid] = 1
        self.ln_obs[lid].clear()
        # initial viewing stats from the creating keyframe
        if 0 <= first_kf < self.n_kf:
            c = self.kf_camera_center(first_kf)
            mid = 0.5 * (np.asarray(ep[0]) + np.asarray(ep[1]))
            v = mid - c
            d = float(np.linalg.norm(v))
            self.ln_normal[lid] = v / max(d, 1e-6)
            self.ln_max_dist[lid] = 1.6 * d
            self.ln_min_dist[lid] = d / 1.6
        return lid

    def add_line_obs(self, lid: int, kf: int, feat: int):
        prev = self.ln_obs[lid].get(kf)
        if prev is not None and prev != feat and self.kf_ln_idx[kf, prev] == lid:
            self.kf_ln_idx[kf, prev] = -1
        self.ln_obs[lid][kf] = feat
        self.kf_ln_idx[kf, feat] = lid

    # ------------------------------------------------------------- keyframes
    def add_keyframe(self, host_frame: HostFrame, R, t, frame_id, timestamp,
                     fd_dev=None) -> int:
        """``fd_dev``: the frame's device FrameData, kept so later passes can
        read keyframe features without re-uploading the snapshot."""
        kf = self.n_kf
        if kf >= self.kf_R.shape[0]:
            raise RuntimeError("keyframe arena full")
        self.kf_R[kf] = R
        self.kf_t[kf] = t
        self.kf_valid[kf] = True
        self.kf_frame_id[kf] = frame_id
        self.kf_timestamp[kf] = timestamp
        self.kf_frames[kf] = host_frame
        self.kf_frames_dev[kf] = fd_dev
        self.n_kf += 1
        return kf

    def kf_camera_center(self, kf: int) -> np.ndarray:
        return -self.kf_R[kf].T @ self.kf_t[kf]

    # ---------------------------------------------------------- covisibility
    def covisibility_counts(self, kf: int) -> dict[int, int]:
        """Shared-map-point counts with every other KF (UpdateConnections),
        as a membership join over the ``kf_pt_idx`` match matrix."""
        row = self.kf_pt_idx[kf]
        pids = row[row >= 0]
        if len(pids) == 0:
            return {}
        lut = np.zeros(self.pt_pos.shape[0], bool)
        lut[pids] = True
        sub = self.kf_pt_idx[: self.n_kf]
        mask = (sub >= 0) & lut[np.clip(sub, 0, None)]
        counts = mask.sum(1)
        counts[kf] = 0
        nz = np.nonzero(counts)[0]
        return {int(o): int(counts[o]) for o in nz}

    def covisible_keyframes(self, kf: int, k: int | None = None,
                            min_weight: int = 1) -> list[int]:
        """Best covisible KFs ordered by weight (GetBestCovisibilityKeyFrames)."""
        counts = self.covisibility_counts(kf)
        ordered = sorted(
            (c, okf) for okf, c in counts.items()
            if c >= min_weight and self.kf_valid[okf]
        )[::-1]
        out = [okf for _, okf in ordered]
        return out[:k] if k is not None else out

    # ------------------------------------------------------------ statistics
    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def n_lines(self) -> int:
        return int(self.ln_valid.sum())

    def reset(self):
        self.__init__(self.cfg, self.device)
