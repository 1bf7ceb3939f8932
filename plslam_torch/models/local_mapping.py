"""Map refinement per new keyframe: the reference's LocalMapping thread as
one sequential pass, the port of the JAX package's ``models/local_mapping.py``.

Covers (LocalMapping.cc):
- ProcessNewKeyFrame (:186-240): observations attach at keyframe creation
  (models.tracking); the spanning tree attaches here;
- MapPointCulling / MapLineCulling (:246-340): found-ratio and
  observation-count rules over the recent-landmark window;
- CreateNewMapPoints / CreateNewMapLines (:346-916): models.triangulation;
- SearchInNeighbors (:922-1104): project neighbour landmarks into the new
  keyframe and the new keyframe's landmarks into its neighbours with a
  tight window, merge duplicates keeping the better-observed landmark
  (ORBmatcher::Fuse, ORBmatcher.cc:1107). The point matches run on the
  gated Hamming kernel, the reverse direction over 10 keyframes in one
  batched launch. Line fusion, dead code in the reference (:1036-1090), is
  live as in the JAX package;
- LocalBundleAdjustment (:119-121 -> Optimizer.cc:644): joint point+line
  local BA (optim.local_ba), dense Schur; the loop closer's global BA runs
  through the same gatherer and, past ``cfg.mapping.ba_dense_camera_cap``
  cameras, the landmark-sharded solver (parallel.ba) when the mesh has
  more than one shard, else the matrix-free PCG solver (optim.ba_cg);
- KeyFrameCulling (:1224-1321).

The map lock (``lock``, Map::mMutexMapUpdate) guards host map mutations
against the tracker when the mapper runs on a worker thread
(models.async_mapping). It is held per stage, never across device work
that waits for a result or across BA iterations. The padded shapes of the
JAX package stay (fusion caps 4096 / 2048 / 512, 10 target keyframes,
power-of-two BA buckets), so the kernels see the same shapes.
"""

from __future__ import annotations

import logging
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import line_matching, matching
from ..optim import ba_cg, local_ba
from ..utils import tracing
from . import distinctive, triangulation
from .map import SlamMap
from .tracking import _to_host

_log = logging.getLogger(__name__)

FUSE_TH_PX = 3.0
FUSE_DESC_TH = 50  # TH_LOW
POINT_CAP = 4096   # forward point fusion candidates
REVERSE_CAP = 2048  # reverse point fusion: the new keyframe's landmarks
LINE_CAP = 512     # line fusion candidates, both directions
K_FIX = 10         # target keyframes of a reverse pass


def fuse_gate(cfg: SlamConfig, kp_xy_un, kp_octave, kp_valid, p3d, mind, maxd, valid,
               R, t, radius_px: float):
    """Gate (..., C, N) of candidate points (C,) projected into one keyframe
    (R (3,3), features (N,)) or a batch of them (R (B,3,3), features
    (B,N)): inside the image and the scale band, a window of
    radius_px * scale^level, octave within [-1, +1] of the predicted one."""
    cam = cfg.camera
    scale = cfg.orb.scale_factor
    pc = p3d @ R.mT + t[..., None, :]
    z = pc[..., 2]
    safe = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * pc[..., 0] / safe + cam.cx
    v = cam.fy * pc[..., 1] / safe + cam.cy
    in_img = (z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    cam_center = -(R.mT @ t[..., None])[..., 0]
    dist = torch.linalg.vector_norm(p3d - cam_center[..., None, :], dim=-1)
    dist_ok = (dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
    ratio = torch.log(maxd.clamp(min=1e-6) / dist.clamp(min=1e-6))
    pred = torch.ceil(ratio / float(np.log(np.float32(scale)))).to(torch.int32) \
        .clamp(0, cfg.orb.n_levels - 1)
    radius = radius_px * scale ** pred.float()
    ok = valid & in_img & dist_ok
    du = (u[..., :, None] - kp_xy_un[..., None, :, 0]).abs()
    dv = (v[..., :, None] - kp_xy_un[..., None, :, 1]).abs()
    r = radius[..., :, None]
    d_oct = kp_octave[..., None, :] - pred[..., :, None]
    return ((du < r) & (dv < r) & (d_oct >= -1) & (d_oct <= 1)
            & ok[..., :, None] & kp_valid[..., None, :])


def fuse_step(cfg: SlamConfig, kp_xy_un, kp_octave, kp_desc, kp_valid,
              p3d, desc, mind, maxd, valid, R, t, radius_px: float = FUSE_TH_PX):
    """Project candidate points into one keyframe and match tightly
    (ORBmatcher::Fuse: th = 3 * scale^level, distance <= TH_LOW). Returns
    (idx, ok) per candidate."""
    gate = fuse_gate(cfg, kp_xy_un, kp_octave, kp_valid, p3d, mind, maxd, valid,
                      R, t, radius_px)
    m = matching.match_descriptors(desc, kp_desc, gate, FUSE_DESC_TH, dedupe=True)
    return m.idx, m.ok


def fuse_multi_step(cfg: SlamConfig, kp_xy_un, kp_octave, kp_desc, kp_valid,
                    p3d, desc, mind, maxd, valid, R, t, radius_px: float = FUSE_TH_PX):
    """Reverse fusion: ONE candidate set (the new keyframe's landmarks)
    against a BATCH of keyframes (features (B, N, ...), R (B,3,3), t (B,3))
    in one batched Hamming launch. Returns (idx, ok), each (B, C)."""
    gate = fuse_gate(cfg, kp_xy_un, kp_octave, kp_valid, p3d, mind, maxd, valid,
                      R, t, radius_px)
    m = matching.match_descriptors_batched(desc, kp_desc, gate.contiguous(), FUSE_DESC_TH,
                                           dedupe=True)
    return m.idx, m.ok


def line_fuse_step(cfg: SlamConfig, f_ep, f_angle, f_length, f_desc, f_valid,
                   cand_ep3d, cand_desc, cand_valid, R, t):
    """Project candidate map lines into a keyframe and run the STRICT line
    gate cascade (LineMatcher::Fuse, LineMatcher.cpp:1207-1379, no relaxed
    retry)."""
    proj = line_matching.project_lines(cfg.camera, R, t, cand_ep3d, cand_valid)
    m = line_matching.match_lines(proj, cand_desc, f_ep, f_angle, f_length, f_desc,
                                  f_valid, cfg.lines, allow_relax=False)
    return m.idx, m.ok


def line_fuse_multi_step(cfg: SlamConfig, f_ep, f_angle, f_length, f_desc, f_valid,
                         cand_ep3d, cand_desc, cand_valid, R, t):
    """Reverse line fusion: one candidate set against a batch of keyframes
    (leading axis B on the frame tensors, R and t). Returns (B, C) tensors."""
    outs = [line_fuse_step(cfg, f_ep[b], f_angle[b], f_length[b], f_desc[b], f_valid[b],
                           cand_ep3d, cand_desc, cand_valid, R[b], t[b])
            for b in range(R.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


class BAGather(NamedTuple):
    """A gathered BA problem and the host indices its write-back needs."""

    prob: local_ba.BAProblem
    cams: list              # keyframe of each camera row
    cam_fixed: np.ndarray   # (C,) bool
    pids: np.ndarray        # map point of each point row
    lids: np.ndarray        # map line of each line row
    oc: np.ndarray          # camera row of each point observation
    op: np.ndarray          # point row of each point observation
    lc: np.ndarray          # camera row of each line observation
    ll: np.ndarray          # line row of each line observation


def _pad(arr, n, shape=(), dtype=np.float32):
    a = np.zeros((n,) + shape, dtype)
    if len(arr):
        a[: len(arr)] = np.asarray(arr, dtype)
    return a


class LocalMapper:
    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, enable_ba: bool = True,
                 kfdb=None):
        self.cfg = cfg
        self.map = slam_map
        # local BA on/off: localization-only mode switches it off
        # (System::ActivateLocalizationMode, System.cc:129-140)
        self.enable_ba = enable_ba
        # keyframe database, if any: a culled keyframe leaves it
        self.kfdb = kfdb
        self.recent_points: list[tuple[int, int]] = []  # (pid, created_at_kf)
        self.recent_lines: list[tuple[int, int]] = []
        # Map::mMutexMapUpdate: held per stage, never across BA iterations
        self.lock = threading.RLock()
        # polled between BA chunks (mbAbortBA, LocalMapping.cc:1107)
        self.should_abort = None
        self.triangulator = triangulation.Triangulator(cfg, slam_map)
        self.fuse_passes = 0  # keyframes whose fusion pass ran
        # landmark-shard mesh of the global BA past the dense cap; None:
        # parallel.mesh.make_ba_mesh() (one shard per visible GPU)
        self.ba_mesh = None

    @staticmethod
    def _bucket(n: int, lo: int, hi: int) -> int:
        """Next power-of-two padding bucket in [lo, hi]."""
        b = lo
        while b < min(n, hi):
            b *= 2
        return min(b, hi)

    def on_new_landmarks(self, kf: int, pt_ids, ln_ids):
        for p in pt_ids:
            if p >= 0:
                self.recent_points.append((int(p), kf))
        for l in ln_ids:
            if l >= 0:
                self.recent_lines.append((int(l), kf))

    # ------------------------------------------------------------------ main
    def process_keyframe(self, kf: int):
        with tracing.span("map.keyframe", kf=kf, frame=int(self.map.kf_frame_id[kf])):
            with self.lock:
                self.map.update_spanning_tree(kf)  # ProcessNewKeyFrame tail
                self.cull_points(kf)
                self.cull_lines(kf)
            self.triangulator.create_new_points(kf, mapper=self, lock=self.lock)
            triangulation.create_new_lines(self.cfg, self.map, kf, mapper=self, lock=self.lock)
            self.fuse(kf)
            if self.enable_ba and self.map.n_kf > 2:
                with tracing.span("map.local_ba"):
                    self.run_local_ba(kf)
            with self.lock:
                self.cull_keyframes(kf)

    # ------------------------------------------------------------- culling
    def _cull(self, recent, current_kf, valid, found, visible, obs, erase):
        mc = self.cfg.mapping
        keep = []
        for lid, born in recent:
            if not valid[lid]:
                continue
            found_ratio = found[lid] / max(visible[lid], 1)
            age = current_kf - born
            if found_ratio < mc.culling_min_found_ratio:
                erase(lid)
            elif age >= 2 and len(obs[lid]) <= mc.culling_min_obs:
                erase(lid)
            elif age < 3:
                keep.append((lid, born))
        return keep

    def cull_points(self, current_kf: int):
        """MapPointCulling (LocalMapping.cc:246-297), RGB-D thresholds."""
        m = self.map
        self.recent_points = self._cull(self.recent_points, current_kf, m.pt_valid,
                                        m.pt_found, m.pt_visible, m.pt_obs, m.erase_point)

    def cull_lines(self, current_kf: int):
        """MapLineCulling (LocalMapping.cc:299-340)."""
        m = self.map
        self.recent_lines = self._cull(self.recent_lines, current_kf, m.ln_valid,
                                       m.ln_found, m.ln_visible, m.ln_obs, m.erase_line)

    def cull_keyframes(self, kf: int):
        """KeyFrameCulling (LocalMapping.cc:1224-1321): retire a covisible
        keyframe when >= 90% of its close map points are observed by >= 3
        other keyframes at the same or a finer scale; KF0 and the current
        keyframe are never culled. One join over ``kf_pt_idx`` gives a
        per-point histogram of observation octaves whose cumulative sum
        answers "how many observers at scale <= L" for every candidate."""
        m = self.map
        th_obs = 3
        th_depth = self.cfg.tracking.th_depth
        cands = [c for c in m.covisible_keyframes(kf)
                 if c != 0 and c != kf and m.kf_valid[c] and m.kf_frames[c] is not None]
        if not cands:
            return
        n_lv = self.cfg.orb.n_levels
        cams = [c for c in range(m.n_kf) if m.kf_valid[c] and m.kf_frames[c] is not None]
        rows = m.kf_pt_idx[cams]                               # (K, N)
        octs = np.stack([m.kf_frames[c].kp_octave for c in cams])
        obs_mask = (rows >= 0) & m.pt_valid[np.clip(rows, 0, None)]
        hist = np.zeros((m.pt_pos.shape[0], n_lv), np.int32)
        np.add.at(hist, (rows[obs_mask],
                         np.clip(octs[obs_mask].astype(np.int32), 0, n_lv - 1)), 1)
        cum = np.cumsum(hist, axis=1)        # cum[p, L] = #obs at octave <= L
        n_obs = cum[:, -1]
        for ckf in cands:
            if not m.kf_valid[ckf]:
                continue
            host = m.kf_frames[ckf]
            row = m.kf_pt_idx[ckf]
            p = np.clip(row, 0, None)
            d = host.kp_depth
            ok = (row >= 0) & m.pt_valid[p] & (d > 0) & (d <= th_depth) & (n_obs[p] > th_obs)
            lvl = np.clip(host.kp_octave.astype(np.int32) + 1, 0, n_lv - 1)
            others = cum[p, lvl] - 1  # the keyframe's own observation counts
            n_pts = int(ok.sum())
            n_red = int((ok & (others >= th_obs)).sum())
            if n_pts > 0 and n_red > self.cfg.mapping.kf_culling_redundancy * n_pts:
                sel = (row >= 0) & m.pt_valid[p]
                m.erase_keyframe(ckf)
                if self.kfdb is not None:
                    self.kfdb.erase(ckf)
                # later candidates must not count the erased keyframe
                np.subtract.at(hist, (row[sel], np.clip(host.kp_octave[sel].astype(np.int32),
                                                        0, n_lv - 1)), 1)
                cum = np.cumsum(hist, axis=1)
                n_obs = cum[:, -1]

    # --------------------------------------------------------------- fusion
    def fuse(self, kf: int):
        """SearchInNeighbors: merge duplicate landmarks between the new
        keyframe and its 2-level covisibility neighbourhood."""
        self._fuse_impl(kf)
        if self.cfg.use_lines:
            self._fuse_lines_impl(kf)
        self.fuse_passes += 1

    def _neighborhood(self, kf: int) -> list[int]:
        """2-level covisibility neighbourhood (LocalMapping.cc:929-950).
        Caller holds the map lock."""
        m = self.map
        neighbors = m.covisible_keyframes(kf, self.cfg.mapping.triangulation_neighbors)
        ext = list(neighbors)
        seen = set(ext) | {kf}
        for n1 in neighbors[:5]:
            for n2 in m.covisible_keyframes(n1, 5):
                if n2 not in seen:
                    ext.append(n2)
                    seen.add(n2)
        return ext

    def _apply_merges(self, pairs, kf_idx, obs, valid, add_obs, replace, prefer_bound):
        """Bind or merge matched (landmark, keyframe, feature) triples;
        caller holds the lock. A free feature gains the observation (the
        IsInKeyFrame guard skips landmarks that already see the keyframe);
        a feature bound to another landmark merges the two, the one with
        more observations winning (the bound one on ties when
        ``prefer_bound``). Returns the landmarks touched."""
        touched = []
        for lid, okf, feat in pairs:
            if not valid[lid] or not self.map.kf_valid[okf]:
                continue
            bound = int(kf_idx[okf, feat])
            if bound < 0:
                if okf not in obs[lid]:
                    add_obs(lid, okf, feat)
                    touched.append(lid)
            elif bound != lid and valid[bound]:
                if prefer_bound:
                    bound_wins = len(obs[bound]) >= len(obs[lid])
                else:
                    bound_wins = len(obs[lid]) < len(obs[bound])
                winner, loser = (bound, lid) if bound_wins else (lid, bound)
                replace(loser, winner)
                touched.append(winner)
        return touched

    def _fuse_impl(self, kf: int):
        m = self.map
        dev = m.device
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        touched: list[int] = []
        with self.lock:
            ext = self._neighborhood(kf)
            if not ext:
                return
            # candidates: observed by neighbours, not by the new keyframe
            own = set(int(p) for p in m.kf_pt_idx[kf] if p >= 0)
            cand = np.unique(m.kf_pt_idx[ext])
            cand = cand[cand >= 0]
            cand = np.array([p for p in cand if m.pt_valid[p] and int(p) not in own],
                            np.int64)[:POINT_CAP]
            k = len(cand)
            p3d = _pad(m.pt_pos[cand], POINT_CAP, (3,))
            mind = _pad(m.pt_min_dist[cand], POINT_CAP)
            maxd = _pad(m.pt_max_dist[cand], POINT_CAP)
            Rk, tk = m.kf_R[kf].copy(), m.kf_t[kf].copy()
            fdv = m.device_frame(kf)
            if k:
                desc = m.point_desc_arena()[up(_pad(cand, POINT_CAP, dtype=np.int64))]
        if k:
            idx, ok = fuse_step(self.cfg, fdv.kp_xy_un, fdv.kp_octave, fdv.kp_desc,
                                fdv.kp_valid, up(p3d), desc, up(mind), up(maxd),
                                up(np.arange(POINT_CAP) < k), up(Rk), up(tk))
            idx, ok = _to_host([idx, ok])
            sel = np.nonzero(ok[:k])[0]
            with self.lock:
                touched += self._apply_merges(
                    ((int(cand[i]), kf, int(idx[i])) for i in sel), m.kf_pt_idx, m.pt_obs,
                    m.pt_valid, m.add_point_obs, self.replace_point, prefer_bound=False)

        # reverse direction / two-view confirmation: the new keyframe's
        # landmarks into its neighbours (LocalMapping.cc:985-1030), with a
        # 5 px window. A depth-seeded landmark that re-finds itself in a
        # neighbour gains its second observation here, which lets it survive
        # MapPointCulling.
        with self.lock:
            own_pids = m.kf_pt_idx[kf]
            own_pids = own_pids[own_pids >= 0]
            own_pids = own_pids[m.pt_valid[own_pids]][:REVERSE_CAP].astype(np.int64)
            targets = ext[:K_FIX]
            k2 = len(own_pids)
            if k2:
                pad_t = targets + [targets[-1]] * (K_FIX - len(targets))
                dev_fr = [m.device_frame(o) for o in pad_t]
                Rs = np.stack([m.kf_R[o] for o in pad_t])
                ts = np.stack([m.kf_t[o] for o in pad_t])
                p3d2 = _pad(m.pt_pos[own_pids], REVERSE_CAP, (3,))
                mind2 = _pad(m.pt_min_dist[own_pids], REVERSE_CAP)
                maxd2 = _pad(m.pt_max_dist[own_pids], REVERSE_CAP)
                desc2 = m.point_desc_arena()[up(_pad(own_pids, REVERSE_CAP, dtype=np.int64))]
        if k2 == 0:
            self._refresh_descriptors(touched)
            return
        K = len(targets)
        kxy = torch.stack([f.kp_xy_un for f in dev_fr])
        koct = torch.stack([f.kp_octave for f in dev_fr])
        kdesc = torch.stack([f.kp_desc for f in dev_fr])
        kval = torch.stack([f.kp_valid if i < K else torch.zeros_like(f.kp_valid)
                            for i, f in enumerate(dev_fr)])
        idx2, ok2 = fuse_multi_step(self.cfg, kxy, koct, kdesc, kval, up(p3d2), desc2,
                                    up(mind2), up(maxd2), up(np.arange(REVERSE_CAP) < k2),
                                    up(Rs), up(ts), radius_px=5.0)
        idx2, ok2 = _to_host([idx2, ok2])
        with self.lock:
            pairs = ((int(own_pids[i]), okf, int(idx2[ki, i]))
                     for ki, okf in enumerate(targets) for i in np.nonzero(ok2[ki, :k2])[0])
            touched += self._apply_merges(pairs, m.kf_pt_idx, m.pt_obs, m.pt_valid,
                                          m.add_point_obs, self.replace_point,
                                          prefer_bound=True)
        self._refresh_descriptors(touched)

    def _fuse_lines_impl(self, kf: int):
        """Line half of SearchInNeighbors (LineMatcher::Fuse,
        LineMatcher.cpp:1207-1379): neighbour lines into the new keyframe
        with the strict cascade, then the new keyframe's lines into the
        neighbour batch."""
        m = self.map
        dev = m.device
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        touched: list[int] = []
        with self.lock:
            ext = self._neighborhood(kf)
            if not ext:
                return
            own = set(int(l) for l in m.kf_ln_idx[kf] if l >= 0)
            cand = np.unique(m.kf_ln_idx[ext])
            cand = cand[cand >= 0]
            cand = np.array([l for l in cand if m.ln_valid[l] and int(l) not in own],
                            np.int64)[:LINE_CAP]
            k = len(cand)
            Rk, tk = m.kf_R[kf].copy(), m.kf_t[kf].copy()
            ep3d = _pad(m.ln_ep[cand], LINE_CAP, (2, 3))
            fdv = m.device_frame(kf)
            if k:
                desc = m.line_desc_arena()[up(_pad(cand, LINE_CAP, dtype=np.int64))]
        if k:
            idx, ok = line_fuse_step(self.cfg, fdv.ln_ep_un, fdv.ln_angle, fdv.ln_length,
                                     fdv.ln_desc, fdv.ln_valid, up(ep3d), desc,
                                     up(np.arange(LINE_CAP) < k), up(Rk), up(tk))
            idx, ok = _to_host([idx, ok])
            sel = np.nonzero(ok[:k])[0]
            with self.lock:
                touched += self._apply_merges(
                    ((int(cand[i]), kf, int(idx[i])) for i in sel), m.kf_ln_idx, m.ln_obs,
                    m.ln_valid, m.add_line_obs, self.replace_line, prefer_bound=False)

        with self.lock:
            own_lids = m.kf_ln_idx[kf]
            own_lids = own_lids[own_lids >= 0]
            own_lids = own_lids[m.ln_valid[own_lids]][:LINE_CAP].astype(np.int64)
            targets = [o for o in ext if m.kf_valid[o]][:K_FIX]
            k2 = len(own_lids)
            if k2 and targets:
                pad_t = targets + [targets[-1]] * (K_FIX - len(targets))
                dev_fr = [m.device_frame(o) for o in pad_t]
                Rs = np.stack([m.kf_R[o] for o in pad_t])
                ts = np.stack([m.kf_t[o] for o in pad_t])
                ep2 = _pad(m.ln_ep[own_lids], LINE_CAP, (2, 3))
                desc2 = m.line_desc_arena()[up(_pad(own_lids, LINE_CAP, dtype=np.int64))]
        if k2 and targets:
            K = len(targets)
            st = lambda name: torch.stack([getattr(f, name) for f in dev_fr])  # noqa: E731
            fval = torch.stack([f.ln_valid if i < K else torch.zeros_like(f.ln_valid)
                                for i, f in enumerate(dev_fr)])
            idx2, ok2 = line_fuse_multi_step(
                self.cfg, st("ln_ep_un"), st("ln_angle"), st("ln_length"), st("ln_desc"),
                fval, up(ep2), desc2, up(np.arange(LINE_CAP) < k2), up(Rs), up(ts))
            idx2, ok2 = _to_host([idx2, ok2])
            with self.lock:
                pairs = ((int(own_lids[i]), okf, int(idx2[ki, i]))
                         for ki, okf in enumerate(targets)
                         for i in np.nonzero(ok2[ki, :k2])[0])
                touched += self._apply_merges(pairs, m.kf_ln_idx, m.ln_obs, m.ln_valid,
                                              m.add_line_obs, self.replace_line,
                                              prefer_bound=True)
        if touched:
            with self.lock:
                distinctive.refresh_line_descriptors(self.map, sorted(set(touched)))

    def _refresh_descriptors(self, touched):
        """ComputeDistinctiveDescriptors over the landmarks the fusion pass
        touched (models.distinctive), under the lock: the preparation walks
        obs dicts the tracker mutates, and the device side only enqueues."""
        if touched:
            with self.lock:
                distinctive.refresh_distinctive_descriptors(self.map, sorted(set(touched)))

    def _replace(self, loser, winner, found, visible, obs, kf_idx, valid):
        """MapPoint::Replace (MapPoint.cc): rebind every observation."""
        found[winner] += found[loser]
        visible[winner] += visible[loser]
        for okf, ofeat in list(obs[loser].items()):
            if okf in obs[winner]:
                kf_idx[okf, ofeat] = -1
            else:
                kf_idx[okf, ofeat] = winner
                obs[winner][okf] = ofeat
        obs[loser].clear()
        valid[loser] = False

    def replace_point(self, loser: int, winner: int):
        m = self.map
        self._replace(loser, winner, m.pt_found, m.pt_visible, m.pt_obs, m.kf_pt_idx,
                      m.pt_valid)

    def replace_line(self, loser: int, winner: int):
        m = self.map
        self._replace(loser, winner, m.ln_found, m.ln_visible, m.ln_obs, m.kf_ln_idx,
                      m.ln_valid)

    # ------------------------------------------------------------- local BA
    def run_local_ba(self, kf: int, window: int | None = None, obs_cap: int | None = None,
                     point_cap: int | None = None, line_cap: int | None = None,
                     lobs_cap: int | None = None, max_kf: int | None = None) -> str | None:
        """Gather the covisibility-local BA problem under the map lock, run
        the stepped LM with the lock released (aborting when a new keyframe
        queues up, mbAbortBA), then write back poses and landmarks and erase
        outlier observations under the lock (Optimizer.cc:644-1063, with
        line landmarks live). The caps default to ``cfg.mapping``'s; the
        loop closer's global BA passes a window that covers every keyframe
        and caps that scale with the map, and ``max_kf`` bounds the global
        set to its snapshot. Returns the solver that ran ("dense", "pcg"
        or "distributed"), or None when the problem has fewer than 20
        observations."""
        g = self.gather_ba(kf, window, obs_cap, point_cap, line_cap, lobs_cap, max_kf)
        if g is None:
            return None
        # iterate without the map lock: the tracker keeps retiring frames
        res, solver = self.solve_ba(g.prob)
        host = _to_host([res.cam_R, res.cam_t, res.pt_xyz, res.ln_ep, res.obs_inlier,
                         res.lobs_inlier])
        with self.lock:
            if solver == "distributed":
                self._transport_lines(g, host[0], host[1], host[3])
            self._write_back_ba(g, *host)
        return solver

    def gather_ba(self, kf: int, window=None, obs_cap=None, point_cap=None, line_cap=None,
                  lobs_cap=None, max_kf=None) -> BAGather | None:
        """The BA problem of :meth:`run_local_ba` on the map's device, with
        what its write-back needs; None below 20 point observations. Takes
        the map lock."""
        m = self.map
        mc = self.cfg.mapping
        dev = m.device
        with self.lock:
            window = window or mc.local_ba_window
            C_max = window + mc.local_ba_fixed_cap
            P = point_cap or mc.local_ba_point_cap
            O = obs_cap or mc.local_ba_obs_cap
            L = line_cap or mc.local_ba_line_cap
            OL = lobs_cap or mc.local_ba_lobs_cap
            n_all = m.n_kf if max_kf is None else min(max_kf, m.n_kf)
            if window >= n_all:
                # global BA: every keyframe of the caller's snapshot
                local = [k for k in range(n_all) if m.kf_valid[k]]
            else:
                local = [kf] + m.covisible_keyframes(kf, window - 1)
            local = local[:window]
            local_set = set(local)
            pids = np.unique(m.kf_pt_idx[local])
            pids = pids[(pids >= 0) & m.pt_valid[np.clip(pids, 0, None)]]
            lids = np.unique(m.kf_ln_idx[local])
            lids = lids[(lids >= 0) & m.ln_valid[np.clip(lids, 0, None)]]
            if len(pids) > P or len(lids) > L:
                _log.warning("local BA caps truncate the problem: %d/%d points, %d/%d lines",
                             min(len(pids), P), len(pids), min(len(lids), L), len(lids))
            pids = pids[:P]
            lids = lids[:L]
            # fixed cameras: other observers of those landmarks
            fixed = []
            fixed_seen = set(local_set)
            for pid in pids:
                for okf in m.pt_obs[pid]:
                    if okf not in fixed_seen:
                        fixed.append(okf)
                        fixed_seen.add(okf)
                if len(fixed) >= mc.local_ba_fixed_cap:
                    break
            cams = local + fixed[: mc.local_ba_fixed_cap]
            nC = len(cams)
            C = self._bucket(nC, 8, C_max)
            cam_R = np.broadcast_to(np.eye(3, dtype=np.float32), (C, 3, 3)).copy()
            cam_t = np.zeros((C, 3), np.float32)
            cam_fixed = np.zeros(C, bool)
            cam_valid = np.zeros(C, bool)
            for i, c in enumerate(cams):
                cam_R[i] = m.kf_R[c]
                cam_t[i] = m.kf_t[c]
                cam_valid[i] = True
                cam_fixed[i] = (i >= len(local)) or (c == 0)
            if not cam_fixed[:nC].any():
                cam_fixed[0] = True  # gauge

            # the observation list is one (nC, N) mask of kf_pt_idx, the
            # inverse observation map (Optimizer.cc:700-800)
            scale = self.cfg.orb.scale_factor
            lut = np.full(m.pt_pos.shape[0], -1, np.int32)
            lut[pids] = np.arange(len(pids), dtype=np.int32)
            rows = m.kf_pt_idx[cams]
            pidx = lut[np.clip(rows, 0, None)]
            ci_arr, feat_arr = np.nonzero((rows >= 0) & (pidx >= 0))
            if len(ci_arr) > O:
                _log.warning("local BA obs cap truncates: %d/%d point obs", O, len(ci_arr))
                ci_arr, feat_arr = ci_arr[:O], feat_arr[:O]
            xy_s = np.stack([m.kf_frames[c].kp_xy_un for c in cams])
            ur_s = np.stack([m.kf_frames[c].kp_ur for c in cams])
            oct_s = np.stack([m.kf_frames[c].kp_octave for c in cams])
            oc = ci_arr.astype(np.int64)
            op = pidx[ci_arr, feat_arr].astype(np.int64)
            ouv = xy_s[ci_arr, feat_arr]
            our = ur_s[ci_arr, feat_arr]
            ow = (1.0 / scale**2) ** oct_s[ci_arr, feat_arr].astype(np.float32)

            llut = np.full(m.ln_ep.shape[0], -1, np.int32)
            llut[lids] = np.arange(len(lids), dtype=np.int32)
            lrows = m.kf_ln_idx[cams]
            lidx = llut[np.clip(lrows, 0, None)]
            lci, lfeat = np.nonzero((lrows >= 0) & (lidx >= 0))
            if len(lci) > OL:
                _log.warning("local BA line-obs cap truncates: %d/%d line obs", OL, len(lci))
                lci, lfeat = lci[:OL], lfeat[:OL]
            lep_s = np.stack([m.kf_frames[c].ln_ep_un for c in cams])
            lc = lci.astype(np.int64)
            ll = lidx[lci, lfeat].astype(np.int64)
            luv = lep_s[lci, lfeat]
            if len(oc) < 20:
                return None
            # pad every axis to the power-of-two bucket of the actual size
            k, kl = len(pids), len(lids)
            P = self._bucket(k, 512, P)
            O = self._bucket(len(oc), 2048, O)
            L = self._bucket(kl, 64, L)
            OL = self._bucket(len(lc), 256, OL)
            pt_xyz = _pad(m.pt_pos[pids], P, (3,))
            ln_ep = _pad(m.ln_ep[lids], L, (2, 3))

        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        prob = local_ba.BAProblem(
            cam_R=up(cam_R), cam_t=up(cam_t), cam_fixed=up(cam_fixed),
            cam_valid=up(cam_valid), pt_xyz=up(pt_xyz), pt_valid=up(np.arange(P) < k),
            obs_cam=up(_pad(oc, O, dtype=np.int64)), obs_pt=up(_pad(op, O, dtype=np.int64)),
            obs_uv=up(_pad(ouv, O, (2,))), obs_ur=up(_pad(our, O)), obs_w=up(_pad(ow, O)),
            obs_valid=up(np.arange(O) < len(oc)),
            ln_ep=up(ln_ep), ln_valid=up(np.arange(L) < kl),
            lobs_cam=up(_pad(lc, OL, dtype=np.int64)), lobs_ln=up(_pad(ll, OL, dtype=np.int64)),
            lobs_uv=up(_pad(luv, OL, (2, 2))), lobs_w=up(_pad(np.ones(len(lc)), OL)),
            lobs_valid=up(np.arange(OL) < len(lc)),
        )
        return BAGather(prob, cams, cam_fixed, pids, lids, oc, op, lc, ll)

    def solve_ba(self, prob: local_ba.BAProblem):
        """(result, solver) of the BA on ``prob``: the dense Schur solve up
        to ``cfg.mapping.ba_dense_camera_cap`` cameras; beyond it, with
        ``cfg.mapping.use_distributed_ba`` and more than one landmark shard
        in the mesh (``self.ba_mesh``, else ``parallel.mesh.make_ba_mesh()``),
        the landmark-sharded GBA (``parallel.ba``, points only: its result
        carries the problem's line endpoints, which ``run_local_ba`` moves
        with their reference keyframes); else the matrix-free PCG
        (``optim/ba_cg.py``)."""
        mc = self.cfg.mapping
        C = prob.cam_R.shape[0]
        if C <= mc.ba_dense_camera_cap:
            return local_ba.bundle_adjust_stepped(
                self.cfg.camera, prob, iters1=mc.local_ba_iters1, iters2=mc.local_ba_iters2,
                should_abort=self.should_abort), "dense"
        if mc.use_distributed_ba:
            from ..parallel import ba as pba
            from ..parallel import mesh as pmesh

            mesh = self.ba_mesh or pmesh.make_ba_mesh()
            if mesh.n_shards > 1:
                nR, nt, nxyz, inl = pba.distributed_bundle_adjust(
                    self.cfg.camera, prob, mesh, iters=mc.distributed_ba_iters,
                    cg_iters=mc.ba_cg_iters, should_abort=self.should_abort)
                dev = prob.cam_R.device
                up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
                return local_ba.BAResult(
                    up(nR), up(nt), up(nxyz), prob.ln_ep, up(inl), prob.lobs_valid,
                    torch.tensor(float("nan"), device=dev)), "distributed"
        return ba_cg.bundle_adjust_cg_stepped(
            self.cfg.camera, prob, iters1=mc.local_ba_iters1, iters2=mc.local_ba_iters2,
            should_abort=self.should_abort, cg_iters=mc.ba_cg_iters), "pcg"

    def _transport_lines(self, g: BAGather, nR, nt, nep):
        """Move the line endpoints of a points-only solve rigidly with their
        reference keyframe's pose update (the loop closer's landmark
        transport). Caller holds the map lock."""
        kl = len(g.lids)
        if not kl:
            return
        cam_index = {c: i for i, c in enumerate(g.cams)}
        ci = np.array([cam_index.get(int(r), -1) for r in self.map.ln_first_kf[g.lids]],
                      np.int64)
        mv = (ci >= 0) & ~g.cam_fixed[np.clip(ci, 0, None)]
        if not mv.any():
            return
        c = ci[mv]
        cam_R, cam_t, ep = _to_host([g.prob.cam_R, g.prob.cam_t, g.prob.ln_ep])
        for i in (0, 1):
            pc = np.einsum("nij,nj->ni", cam_R[c], ep[:kl][mv, i]) + cam_t[c]
            nep[:kl][mv, i] = np.einsum("nji,nj->ni", nR[c], pc - nt[c])

    def _write_back_ba(self, g: BAGather, nR, nt, nxyz, nep, inl, linl):
        """A BA result (host arrays) back into the map: poses and landmarks,
        guarding landmarks and keyframes erased while BA ran, and the
        outlier observations erased (Optimizer.cc:1010-1045). Caller holds
        the map lock."""
        m = self.map
        k, kl = len(g.pids), len(g.lids)
        for i, c in enumerate(g.cams):
            if not g.cam_fixed[i] and m.kf_valid[c]:
                m.set_kf_pose(c, nR[i], nt[i])
        still = m.pt_valid[g.pids]
        m.pt_pos[g.pids[still]] = nxyz[:k][still]
        lstill = m.ln_valid[g.lids]
        m.ln_ep[g.lids[lstill]] = nep[:kl][lstill]
        for j in np.nonzero(~inl[:len(g.oc)])[0]:
            pid = int(g.pids[g.op[j]])
            okf = g.cams[g.oc[j]]
            feat = m.pt_obs[pid].pop(okf, None)
            if feat is not None:
                m.kf_pt_idx[okf, feat] = -1
            if len(m.pt_obs[pid]) == 0:
                m.erase_point(pid)
        for j in np.nonzero(~linl[:len(g.lc)])[0]:
            lid = int(g.lids[g.ll[j]])
            okf = g.cams[g.lc[j]]
            feat = m.ln_obs[lid].pop(okf, None)
            if feat is not None:
                m.kf_ln_idx[okf, feat] = -1
            if len(m.ln_obs[lid]) == 0:
                m.erase_line(lid)
