"""Loop closing: detection, relative-pose solve, correction, global refine.

The port of the JAX package's ``models/loop_closing.py``, the reference's
``LoopClosing`` thread (LoopClosing.cc) as one sequential pass per keyframe:

- DetectLoop (:143-341): minimum BoW score over the keyframe's connected
  views, database candidates outside a covisibility and recency exclusion,
  a group-connectivity gate, and covisibility-consistency chaining over
  >= 3 consecutive keyframes.
- ComputeSim3 (:359-617): a dense ratio match of the two keyframes'
  features through the Hamming kernel (1024 x 1024, gate has_point x
  has_point), a 3-point Horn RANSAC seed on the camera-frame 3D pairs, two
  SearchBySim3 expansion rounds (ORBmatcher.cc:1441-1599: kf2's landmarks
  projected into kf1 at 15 then 9 px, matched against the minimum of the
  feature's and the landmark's descriptor distance in ONE batched launch
  with B = 2, ``ops.matching.match_min_of_two``), each followed by RANSAC
  and ``refine_sim3``; then the projection verification of kf2's
  neighbourhood into kf1 (``fuse_step`` at 10 px, 4096 candidates) with
  the map lines as corroborating evidence.
- CorrectLoop (:619-891): propagate the corrected pose to kf1's covisibility
  group and its landmarks, SearchAndFuse (the loop side's landmarks into
  the corrected group, ``fuse_multi_step``: 10 keyframes x 4096 landmarks
  in one batched launch, the loop side winning merges), the essential graph
  (``optim/pose_graph.py``, SE(3), or Sim(3) when the scale is not fixed),
  landmark transport, and a global BA through the local mapper's gatherer
  (dense Schur, or the matrix-free PCG past ``ba_dense_camera_cap``).

The corrected pose reaches the tracker through its gauge-correction
protocol (``Tracker.apply_gauge_correction``), not through a stop of the
tracker. RANSAC draws come from a ``torch.Generator`` on the map's device
seeded from kf1 and the round (``loop_generator``), or are injected
(``horn_samples``) to reproduce another implementation's draws. The caps of
the JAX package stay (4096 loop-side landmarks, 10 target keyframes, 256
lines, 512 Sim3 pairs) and each logs when it truncates.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import line_matching, matching
from ..optim import horn, pose_graph
from .local_mapping import fuse_multi_step, fuse_step
from .map import SlamMap
from .tracking import _to_host

_log = logging.getLogger(__name__)

SIM3_MATCH_MIN = 20
# RANSAC seed bar before the SearchBySim3 expansion (the >= 20 acceptance
# bar applies to the expanded set, LoopClosing.cc:450-480)
SIM3_SEED_INLIERS = 8
LOOP_PROJ_ACCEPT = 40
# minimum shared-point weight for a fused cross-sector pair to become an
# essential-graph loop connection (Optimizer.cc:1131 uses 100)
LOOP_CONN_MIN_WEIGHT = 30
# agreeing map-line matches that corroborate a borderline point count in
# the verification (no reference analogue: its loops are points-only)
LOOP_LINE_ACCEPT = 5
SIM3_PAIRS = 512      # 3D-3D pairs given to RANSAC and refine_sim3
VERIFY_CAP = 4096     # neighbourhood landmarks projected in the verification
FUSE_POINT_CAP = 4096  # loop-side landmarks of SearchAndFuse
FUSE_TARGETS = 10     # corrected-group keyframes of SearchAndFuse
LINE_CAP = 256        # neighbourhood map lines in the line verification


def loop_generator(device, kf1: int, rnd: int) -> torch.Generator:
    """The RANSAC draws of round ``rnd`` (0: the seed, 1 and 2: the
    expansion rounds) of the relative-pose solve for keyframe ``kf1``."""
    g = torch.Generator(device=device)
    g.manual_seed(kf1 * 16 + rnd)
    return g


class _PairSnapshot(NamedTuple):
    """What the relative-pose solve reads of the live map, copied under the
    map lock: the landmark positions of kf1's and kf2's features (row per
    feature; rows of features without a landmark are landmark 0's, never
    read) and both keyframes' poses. A local BA written back in the middle
    of the solve cannot tear it."""

    pos1: np.ndarray
    pos2: np.ndarray
    R1: np.ndarray
    t1: np.ndarray
    R2: np.ndarray
    t2: np.ndarray

    @classmethod
    def take(cls, m: SlamMap, kf1, kf2, p1, p2):
        return cls(m.pt_pos[np.clip(p1, 0, None)], m.pt_pos[np.clip(p2, 0, None)],
                   m.kf_R[kf1].copy(), m.kf_t[kf1].copy(), m.kf_R[kf2].copy(),
                   m.kf_t[kf2].copy())


def _pair_arrays(snap, ok, idx):
    """Camera-frame 3D pairs of the matched landmarks, padded to
    SIM3_PAIRS: (src = kf2's, dst = kf1's, valid). ``snap`` is the
    :class:`_PairSnapshot` taken under the map lock."""
    x1 = snap.pos1[ok] @ snap.R1.T + snap.t1
    x2 = snap.pos2[idx[ok]] @ snap.R2.T + snap.t2
    src = np.zeros((SIM3_PAIRS, 3), np.float32)
    dst = np.zeros((SIM3_PAIRS, 3), np.float32)
    val = np.zeros(SIM3_PAIRS, bool)
    k = min(len(x1), SIM3_PAIRS)
    if len(x1) > SIM3_PAIRS:
        _log.warning("Sim3 pair cap truncates: %d/%d pairs", SIM3_PAIRS, len(x1))
    src[:k] = x2[:k]
    dst[:k] = x1[:k]
    val[:k] = True
    return src, dst, val


def global_ba_caps(m: SlamMap) -> dict:
    """The global BA's window (every keyframe) and caps, which scale with
    the map: the keywords of ``LocalMapper.run_local_ba``."""
    point_cap = 1 << max(12, (max(m.n_points(), 1) - 1).bit_length())
    line_cap = 1 << max(8, (max(m.n_lines(), 1) - 1).bit_length())
    return dict(window=1 << max(8, (m.n_kf - 1).bit_length()), point_cap=point_cap,
                obs_cap=max(65536, 4 * point_cap), line_cap=line_cap,
                lobs_cap=max(4096, 4 * line_cap))


def _pad_landmarks(m: SlamMap, pids, cap: int):
    """(p3d, min dist, max dist, valid, padded ids) of ``pids[:cap]``."""
    k = min(len(pids), cap)
    p3d = np.zeros((cap, 3), np.float32)
    mind = np.zeros(cap, np.float32)
    maxd = np.ones(cap, np.float32)
    valid = np.zeros(cap, bool)
    pid_pad = np.zeros(cap, np.int64)
    p3d[:k] = m.pt_pos[pids[:k]]
    mind[:k] = m.pt_min_dist[pids[:k]]
    maxd[:k] = m.pt_max_dist[pids[:k]]
    valid[:k] = True
    pid_pad[:k] = pids[:k]
    return p3d, mind, maxd, valid, pid_pad


class LoopCloser:
    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, kfdb, voc, local_mapper=None,
                 tracker=None):
        self.cfg = cfg
        self.map = slam_map
        self.kfdb = kfdb
        self.voc = voc
        self.local_mapper = local_mapper
        self.tracker = tracker
        self.prev_groups: list[tuple[set[int], int]] = []
        self.last_loop_kf = -(10**9)
        self.last_loop_pair: tuple[int, int] | None = None  # (kf1, kf2)
        self.n_loops_closed = 0
        self.enable_gba = True
        # the map lock shared with the mapper and the tracker (an RLock:
        # the synchronous call path nests it); held for host mutation only
        self.lock = getattr(local_mapper, "lock", None) or threading.RLock()
        # held across a correction when both run on worker threads
        # (AsyncLoopCloser sets it to the AsyncLocalMapper's pass lock)
        self.mapping_pause = None

    # ------------------------------------------------------------------ main
    def process_keyframe(self, kf: int):
        if self.map.n_kf < self.cfg.loop.min_kf_gap:
            return
        if kf < self.last_loop_kf + self.cfg.loop.min_kf_gap:
            return
        with self.lock:  # host walks over live map state
            cands = self._detect_loop(kf)
        for cand in cands:
            out = self._compute_relative(kf, cand)
            if out is not None:
                R12, t12, s12, _ = out
                self._correct_loop(kf, cand, R12, t12, s12)
                self.n_loops_closed += 1
                self.last_loop_kf = kf
                self.last_loop_pair = (kf, cand)
                return

    # ----------------------------------------------------------- detection
    def _detect_loop(self, kf: int) -> list[int]:
        """Consistent loop candidates of ``kf``. Caller holds the lock."""
        m = self.map
        bow = self.kfdb.get_bow(kf)
        covis = set(m.covisible_keyframes(kf))
        # the min-score floor (LoopClosing.cc:167-185) over the connected
        # views: covisible keyframes and the recent temporal ones (an island
        # keyframe after a discontinuity falls back to those alone)
        anchors = set(covis)
        anchors |= {q for q in range(max(0, kf - 5), kf) if m.kf_valid[q] and self.kfdb.has[q]}
        if not anchors:
            return []
        scores = self.kfdb.score_all(bow)
        min_score = min(scores[c] for c in anchors)
        # exclusion: the covisible set (KeyFrameDatabase.cc:129-141) and a
        # recency window, so a loop connects to the distant past
        exclude = covis | set(range(max(0, kf - 10), kf + 1))
        cands = self.kfdb.detect_loop_candidates(kf, bow, float(min_score), exclude, m)
        # group-connectivity gate: a candidate whose group is already
        # strongly connected to the current group has been absorbed by
        # fusion; loop closing is for disconnected sectors
        th_strong = self.cfg.loop.group_connectivity_min
        strong = set()
        for g in [kf] + m.covisible_keyframes(kf, 20, min_weight=15):
            strong.update(o for o, c in m.covisibility_counts(g).items() if c >= th_strong)
            strong.add(g)
        cands = [c for c in cands if not (({c} | set(m.covisible_keyframes(c, 10))) & strong)]
        # consistency chaining (LoopClosing.cc:203-341)
        current_groups: list[tuple[set[int], int]] = []
        consistent: list[int] = []
        for c in cands:
            group = set(m.covisible_keyframes(c, 10)) | {c}
            count = 0
            for prev_set, prev_count in self.prev_groups:
                if group & prev_set:
                    count = max(count, prev_count + 1)
            current_groups.append((group, count))
            if count >= self.cfg.loop.covisibility_consistency_th - 1:
                consistent.append(c)
        self.prev_groups = current_groups
        return consistent

    # ------------------------------------------------------- relative pose
    def _compute_relative(self, kf1: int, kf2: int, horn_samples=None):
        """Match kf1's map points against kf2's, Horn-RANSAC the camera-frame
        3D pairs, grow the set by two SearchBySim3 rounds, verify by
        neighbourhood projection. Returns (R12, t12, s12, n_matches) with
        x_c1 = s12 R12 x_c2 + t12 (numpy), or None. ``horn_samples``: the
        three rounds' RANSAC index sets (n_hyp, 3), else drawn from
        :func:`loop_generator`."""
        m = self.map
        cfg = self.cfg
        dev = m.device
        with_scale = not cfg.loop.fix_scale
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

        def ransac(src, dst, val, rnd):
            return horn.ransac_align(
                up(src), up(dst), up(val), loop_generator(dev, kf1, rnd), thresh=0.10,
                with_scale=with_scale, samples=None if horn_samples is None else horn_samples[rnd])

        with self.lock:
            p1 = m.kf_pt_idx[kf1].copy()
            p2 = m.kf_pt_idx[kf2].copy()
            has1 = (p1 >= 0) & m.pt_valid[np.clip(p1, 0, None)]
            has2 = (p2 >= 0) & m.pt_valid[np.clip(p2, 0, None)]
            if has1.sum() < SIM3_MATCH_MIN or has2.sum() < SIM3_MATCH_MIN:
                return None
            d1 = m.device_frame(kf1)
            d2 = m.device_frame(kf2)
            h1, h2 = m.kf_frames[kf1], m.kf_frames[kf2]
            pt_desc2 = m.point_desc_arena()[up(np.clip(p2, 0, None).astype(np.int64))]
            snap = _PairSnapshot.take(m, kf1, kf2, p1, p2)
        gate = up(has1)[:, None] & up(has2)[None, :]
        mm = matching.match_descriptors(d1.kp_desc, d2.kp_desc, gate, 60,
                                        nn_ratio=cfg.matcher.nn_ratio_reloc, dedupe=True)
        ok, idx = (a.copy() for a in _to_host([mm.ok, mm.idx]))
        n_match = int(ok.sum())
        if n_match < SIM3_MATCH_MIN:
            return None
        src, dst, val = _pair_arrays(snap, ok, idx)
        s, R12, t12, _, n_inl = ransac(src, dst, val, 0)
        # a small coherent seed bootstraps the expansion; the >= 20 bar
        # applies after it
        if int(n_inl) < SIM3_SEED_INLIERS:
            return None
        # SearchBySim3 expansion (ORBmatcher.cc:1441-1599, driven from
        # LoopClosing.cc:450-480): kf2's landmarks projected into kf1's
        # image at the current estimate harvest the matches the
        # appearance-only ratio test missed; wide radius from the seed, then
        # tighter from the refined similarity
        cam = cfg.camera
        t_desc2 = torch.stack([d2.kp_desc, pt_desc2])
        x2_all = snap.pos2 @ snap.R2.T + snap.t2
        s_n = 0
        for rnd, rad in ((1, 15.0), (2, 9.0)):
            s0 = float(s)
            R0, t0 = R12.cpu().numpy(), t12.cpu().numpy()
            x1_pred = s0 * (x2_all @ R0.T) + t0
            z = x1_pred[:, 2]
            uv_pred = np.stack([cam.fx * x1_pred[:, 0] / np.maximum(z, 1e-6) + cam.cx,
                                cam.fy * x1_pred[:, 1] / np.maximum(z, 1e-6) + cam.cy], -1)
            pix_d = np.linalg.norm(h1.kp_xy_un[:, None, :] - uv_pred[None, :, :], axis=-1)
            gate2 = has1[:, None] & has2[None, :] & (z > 0.1)[None, :] & (pix_d < rad)
            mm2 = matching.match_min_of_two(d1.kp_desc, t_desc2, up(gate2), 50)
            ok2, idx2 = _to_host([mm2.ok, mm2.idx])
            # earlier (ratio-test or previous-round) matches win
            grown = ok2 & ~ok
            ok = ok | grown
            idx = np.where(grown, idx2, idx)
            src, dst, val = _pair_arrays(snap, ok, idx)
            s, R12, t12, _, n_inl = ransac(src, dst, val, rnd)
            if int(n_inl) < SIM3_SEED_INLIERS:
                return None
            # Sim3 LM on the bidirectional reprojections
            # (Optimizer::OptimizeSim3, Optimizer.cc:1400-1659)
            feats1 = np.nonzero(ok)[0][:SIM3_PAIRS]
            feats2 = idx[feats1]
            uv1 = np.zeros((SIM3_PAIRS, 2), np.float32)
            uv2 = np.zeros((SIM3_PAIRS, 2), np.float32)
            uv1[: len(feats1)] = h1.kp_xy_un[feats1]
            uv2[: len(feats1)] = h2.kp_xy_un[feats2]
            s_r, R_r, t_r, _, s_n = horn.refine_sim3(
                cam, s, R12, t12, up(dst), up(uv1), up(src), up(uv2), up(val),
                with_scale=with_scale)
            if int(s_n) >= max(SIM3_SEED_INLIERS, int(n_inl)):
                s, R12, t12 = s_r, R_r, t_r
        # acceptance (OptimizeSim3's nInliers >= 20, LoopClosing.cc:480): a
        # count at >= 0.75x may proceed to the verification below, which
        # is the far stronger test
        n_sim3 = max(int(s_n), int(n_inl))
        if n_sim3 < int(0.75 * cfg.loop.sim3_min_inliers):
            return None
        strict_sim3 = n_sim3 >= cfg.loop.sim3_min_inliers
        s12 = float(s)
        R12 = R12.cpu().numpy()
        t12 = t12.cpu().numpy()

        # verification: kf2's neighbourhood projected into kf1 at the
        # corrected pose (LoopClosing.cc:575-607), radius 10 px x scale
        with self.lock:
            neigh = [kf2] + m.covisible_keyframes(kf2, 10)
            pids = np.unique(m.kf_pt_idx[neigh])
            pids = pids[(pids >= 0) & m.pt_valid[np.clip(pids, 0, None)]]
            if len(pids) == 0:
                return None
            Rc = R12 @ m.kf_R[kf2]  # T_c1w = T_12 ∘ T_c2w
            tc = R12 @ m.kf_t[kf2] + t12
            if len(pids) > VERIFY_CAP:
                _log.warning("loop verification cap truncates: %d/%d landmarks", VERIFY_CAP,
                             len(pids))
            k = min(len(pids), VERIFY_CAP)
            p3d, mind, maxd, valid, pid_pad = _pad_landmarks(m, pids, VERIFY_CAP)
            desc = m.point_desc_arena()[up(pid_pad)]
        _, fok = fuse_step(cfg, d1.kp_xy_un, d1.kp_octave, d1.kp_desc, d1.kp_valid, up(p3d),
                           desc, up(mind), up(maxd), up(valid), up(Rc), up(tc), radius_px=10.0)
        n_proj = int(fok[:k].sum())
        n_line = self._count_line_agreement(kf2, d1, Rc, tc) if cfg.use_lines else 0
        if n_proj < LOOP_PROJ_ACCEPT and not (
                n_proj >= int(0.7 * LOOP_PROJ_ACCEPT) and n_line >= LOOP_LINE_ACCEPT):
            return None
        if not strict_sim3 and n_proj < 2 * LOOP_PROJ_ACCEPT and n_line < LOOP_LINE_ACCEPT:
            # an under-strength Sim3 set needs overwhelming support
            return None
        return R12, t12, s12, n_match

    def _count_line_agreement(self, kf2: int, d1, Rc, tc) -> int:
        """kf2's neighbourhood map lines matched against kf1's lines under
        the corrected pose (strict cascade, no relaxed retry)."""
        m = self.map
        dev = m.device
        with self.lock:
            neigh = [kf2] + m.covisible_keyframes(kf2, 10)
            lids = np.unique(m.kf_ln_idx[neigh])
            lids = lids[(lids >= 0) & m.ln_valid[np.clip(lids, 0, None)]]
            if len(lids) == 0:
                return 0
            if len(lids) > LINE_CAP:
                _log.warning("loop line verification cap truncates: %d/%d lines", LINE_CAP,
                             len(lids))
            kl = min(len(lids), LINE_CAP)
            ep = np.zeros((LINE_CAP, 2, 3), np.float32)
            lval = np.zeros(LINE_CAP, bool)
            lid_pad = np.zeros(LINE_CAP, np.int64)
            ep[:kl] = m.ln_ep[lids[:kl]]
            lval[:kl] = True
            lid_pad[:kl] = lids[:kl]
            ldesc = m.line_desc_arena()[torch.as_tensor(lid_pad, device=dev)]
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        projl = line_matching.project_lines(self.cfg.camera, up(Rc), up(tc), up(ep), up(lval))
        res = line_matching.match_lines(projl, ldesc, d1.ln_ep_un, d1.ln_angle, d1.ln_length,
                                        d1.ln_desc, d1.ln_valid, self.cfg.lines,
                                        allow_relax=False)
        return int(res.count)

    # ---------------------------------------------------------- correction
    def _correct_loop(self, kf1: int, kf2: int, R12, t12, s12=1.0):
        """CorrectLoop. For RGB-D ``s12`` is 1 (fixed scale); a monocular
        similarity's scale folds into the written SE3 poses as [R | t/s]
        (the reference's CorrectedSim3 write-back, LoopClosing.cc:700-760).

        ``mapping_pause`` (the asynchronous local mapper's ``pass_lock``, set
        by ``AsyncLoopCloser``) is held throughout, as CorrectLoop first
        stops LocalMapping: a mapping pass that read the poses before the
        correction and wrote them back after it would put the corrected
        keyframes back where they were (measured on the orbit of
        RoomScene(3): a local BA gathered before the propagation moved the
        loop keyframe back by 49 cm). The tracker keeps running."""
        with self.mapping_pause or contextlib.nullcontext():
            self._correct_loop_paused(kf1, kf2, R12, t12, s12)

    def _correct_loop_paused(self, kf1, kf2, R12, t12, s12):
        m = self.map
        with self.lock:
            # pre-correction poses: the essential graph's tree and
            # covisibility edges are measured from the drifted but smooth
            # odometry (NonCorrectedSim3, LoopClosing.cc:670-700)
            K0 = m.n_kf
            R_before = m.kf_R[:K0].copy()
            t_before = m.kf_t[:K0].copy()
            # corrected current pose: S_1w = S_12 ∘ S_2w
            R1_corr = R12 @ m.kf_R[kf2]
            t1_corr = s12 * (R12 @ m.kf_t[kf2]) + t12
            group = [kf1] + m.covisible_keyframes(kf1)
            R1_old = m.kf_R[kf1].copy()
            t1_old = m.kf_t[kf1].copy()
            self._propagate_group(group, R1_old, t1_old, R1_corr, t1_corr, s12)
            gset = set(group)
            pre_covis = {g: set(m.covisibility_counts(g)) for g in group if m.kf_valid[g]}
        # SearchAndFuse stitches the two sectors' observation graphs; the
        # pairs it newly connects become LoopConnections (:768-791)
        self._search_and_fuse(group, kf2)
        loop_conns: list[tuple[int, int]] = []
        with self.lock:
            for g, before in pre_covis.items():
                for o, c in m.covisibility_counts(g).items():
                    if (o not in gset and o not in before and c >= LOOP_CONN_MIN_WEIGHT
                            and m.kf_valid[o]):
                        loop_conns.append((o, g))
        self._optimize_essential_graph(kf1, kf2, gset, R_before, t_before,
                                       loop_conns=loop_conns, group_scale=s12)
        # global BA (the reference spawns a GBA thread; here it runs on the
        # thread that called, a worker under AsyncLoopCloser)
        if self.enable_gba:
            self._global_ba(kf1)
        with self.lock:
            m.loop_edges.append((kf2, kf1))  # KeyFrame::AddLoopEdge
            m.big_change_idx += 1
            if self.tracker is not None:
                # the rigid gauge delta D = T1_old^-1 ∘ T1_final, folded into
                # the tracker's pipelined state at its next frame
                Rd = R1_old.T @ m.kf_R[kf1]
                td = R1_old.T @ (m.kf_t[kf1] - t1_old)
                self.tracker.apply_gauge_correction(Rd, td)

    def _propagate_group(self, group, R1_old, t1_old, R1_corr, t1_corr, s1_corr):
        """The corrected kf1 pose propagated to its covisibility group and
        their landmarks (CorrectedSim3). Caller holds the lock."""
        m = self.map
        R1_old_inv = R1_old.T
        t1_old_inv = -R1_old_inv @ t1_old
        corrected_pts: set[int] = set()
        for k in group:
            # S_k1 = T_kw_old ∘ T_1w_old^-1 ; S_kw_new = S_k1 ∘ S_1w_new
            Rk1 = m.kf_R[k] @ R1_old_inv
            tk1 = m.kf_R[k] @ t1_old_inv + m.kf_t[k]
            R_new = Rk1 @ R1_corr
            t_new = Rk1 @ t1_corr + tk1
            s_new = s1_corr
            # landmarks: pw' = S_kw_new^-1 (T_kw_old pw)
            pids = m.kf_pt_idx[k]
            pids = np.array([p for p in pids[pids >= 0]
                             if m.pt_valid[p] and p not in corrected_pts], np.int64)
            if len(pids):
                pc = m.pt_pos[pids] @ m.kf_R[k].T + m.kf_t[k]
                m.pt_pos[pids] = ((pc - t_new) / s_new) @ R_new
                corrected_pts.update(int(p) for p in pids)
            lids = m.kf_ln_idx[k]
            lids = np.array([l for l in lids[lids >= 0] if m.ln_valid[l]], np.int64)
            if len(lids):
                for i in (0, 1):
                    epc = m.ln_ep[lids, i] @ m.kf_R[k].T + m.kf_t[k]
                    m.ln_ep[lids, i] = ((epc - t_new) / s_new) @ R_new
            m.set_kf_pose(k, R_new, t_new / s_new)  # [R | t/s]

    def _search_and_fuse(self, group, kf2: int):
        """SearchAndFuse (LoopClosing.cc:893-931): the loop side's
        neighbourhood landmarks projected into every corrected group
        keyframe and bound or merged, the loop side's landmark winning
        (``pRep->Replace(mvpLoopMapPoints[i])``)."""
        m = self.map
        dev = m.device
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        with self.lock:
            neigh = [kf2] + m.covisible_keyframes(kf2, 10)
            pids, counts = np.unique(m.kf_pt_idx[neigh], return_counts=True)
            keep = (pids >= 0) & m.pt_valid[np.clip(pids, 0, None)]
            pids, counts = pids[keep], counts[keep]
            if len(pids) == 0:
                return
            if len(pids) > FUSE_POINT_CAP:
                # keep the most-observed landmarks, the strongest anchors
                _log.warning("SearchAndFuse point cap truncates: %d/%d loop-side landmarks",
                             FUSE_POINT_CAP, len(pids))
                pids = pids[np.argsort(-counts, kind="stable")[:FUSE_POINT_CAP]]
            targets = [g for g in group if m.kf_valid[g]]
            if len(targets) > FUSE_TARGETS:
                _log.warning("SearchAndFuse target cap truncates: %d/%d group keyframes",
                             FUSE_TARGETS, len(targets))
                targets = targets[:FUSE_TARGETS]
            if not targets:
                return
            k = min(len(pids), FUSE_POINT_CAP)
            p3d, mind, maxd, valid, pid_pad = _pad_landmarks(m, pids, FUSE_POINT_CAP)
            pad_t = targets + [targets[-1]] * (FUSE_TARGETS - len(targets))
            dev_fr = [m.device_frame(o) for o in pad_t]
            Rs = np.stack([m.kf_R[o] for o in pad_t])
            ts = np.stack([m.kf_t[o] for o in pad_t])
            desc = m.point_desc_arena()[up(pid_pad)]
        st = lambda name: torch.stack([getattr(f, name) for f in dev_fr])  # noqa: E731
        kval = torch.stack([f.kp_valid if i < len(targets) else torch.zeros_like(f.kp_valid)
                            for i, f in enumerate(dev_fr)])
        idx2, ok2 = fuse_multi_step(self.cfg, st("kp_xy_un"), st("kp_octave"), st("kp_desc"),
                                    kval, up(p3d), desc, up(mind), up(maxd), up(valid), up(Rs),
                                    up(ts), radius_px=5.0)
        idx2, ok2 = _to_host([idx2, ok2])
        base = getattr(self.local_mapper, "inner", self.local_mapper)
        if base is None:
            return
        touched: list[int] = []
        with self.lock:
            for ki, okf in enumerate(targets):
                for i in np.nonzero(ok2[ki, :k])[0]:
                    pid = int(pids[i])
                    if not m.pt_valid[pid]:
                        continue
                    feat = int(idx2[ki, i])
                    bound = int(m.kf_pt_idx[okf, feat])
                    if bound < 0:
                        if okf not in m.pt_obs[pid]:
                            m.add_point_obs(pid, okf, feat)
                            touched.append(pid)
                    elif bound != pid and m.pt_valid[bound]:
                        base.replace_point(bound, pid)  # the loop side wins
                        touched.append(pid)
        if touched:
            base._refresh_descriptors(touched)

    def _optimize_essential_graph(self, kf1: int, kf2: int, group: set[int], R_before=None,
                                  t_before=None, loop_conns=None, group_scale=1.0):
        """Essential-graph pose optimization (Optimizer.cc:1064-1399). Tree
        and covisibility edges are measured from ``R_before / t_before``,
        the poses before the propagation; only the loop edges use the
        corrected poses. ``group_scale``: the correction's scale (mono; 1
        for RGB-D); the map stores the corrected group as scale-folded SE3
        ([R | t/s]), and the 7-dof solver starts them at their true Sim3
        (scale s, translation s t)."""
        m = self.map
        with self.lock:
            K = m.n_kf
            prob, s_node, s_meas = self._build_essential_problem(
                kf1, kf2, K, R_before, t_before, loop_conns or [], group=group,
                group_scale=group_scale)
        iters = self.cfg.loop.essential_graph_iters
        if self.cfg.loop.fix_scale:
            Rn, tn = pose_graph.optimize_pose_graph(prob, iters=iters)
            sn = np.ones(Rn.shape[0], np.float32)
            s_old = None
        else:
            # monocular: 7-dof nodes absorb the scale drift (fix_scale=false,
            # Optimizer.cc:1135-1160)
            dev = prob.R.device
            t_init = prob.t.clone()
            gl = [k for k in group if k < K]
            t_init[gl] = t_init[gl] * group_scale
            sprob = pose_graph.Sim3GraphProblem(
                R=prob.R, t=t_init, s=torch.as_tensor(s_node, device=dev), fixed=prob.fixed,
                valid=prob.valid, ei=prob.ei, ej=prob.ej, R_meas=prob.R_meas,
                t_meas=prob.t_meas, s_meas=torch.as_tensor(s_meas, device=dev), w=prob.w,
                e_valid=prob.e_valid)
            Rn, tn, sn = pose_graph.optimize_pose_graph_sim3(sprob, iters=iters)
            sn = sn.cpu().numpy()
            s_old = s_node[:K]
        Rn, tn = Rn.cpu().numpy(), tn.cpu().numpy()
        with self.lock:
            # apply (mono: scale folded into SE3) and move the landmarks with
            # their reference keyframe; keyframes appended meanwhile follow
            # their anchors
            old_R = m.kf_R[:K].copy()
            old_t = m.kf_t[:K].copy()
            for k in range(K):
                if m.kf_valid[k]:
                    m.set_kf_pose(k, Rn[k], tn[k] / sn[k])
            self._transport_landmarks(K, old_R, old_t, Rn, tn, sn, s_old=s_old)
            self._correct_appended_kfs(K, old_R, old_t)

    def _build_essential_problem(self, kf1, kf2, K, R_before, t_before, loop_conns=(),
                                 group=(), group_scale=1.0):
        """(SE3 problem on the map's device, node scales, edge scale
        measurements). Node scales are 1 except the corrected group under a
        scaled correction; an edge measured from corrected poses between
        nodes of scales (s_i, s_j) measures s_i / s_j. Caller holds the
        lock."""
        m = self.map
        conn_set = {frozenset(p) for p in loop_conns}
        if R_before is None:
            R_src, t_src = m.kf_R, m.kf_t
        else:
            R_src = np.concatenate([R_before, m.kf_R[len(R_before):K]])
            t_src = np.concatenate([t_before, m.kf_t[len(t_before):K]])
        KCAP = 1 << (K - 1).bit_length()
        edges = []  # (i, j, weight, measured from the current poses)
        # spanning tree (Optimizer.cc:1180); the previous surviving keyframe
        # for rows never attached
        prev_valid = -1
        for k in range(1, K):
            if not m.kf_valid[k]:
                continue
            p = int(m.kf_parent[k])
            if p < 0 or not m.kf_valid[p]:
                p = prev_valid
            if p >= 0:
                edges.append((p, k, 1.0, False))
            prev_valid = k
        # strong covisibility, except pairs the loop fusion connected
        for k in range(K):
            if not m.kf_valid[k]:
                continue
            for o, c in m.covisibility_counts(k).items():
                if c >= 100 and o > k + 1 and frozenset((k, o)) not in conn_set:
                    edges.append((k, o, 1.0, False))
        # LoopConnections (Optimizer.cc:1123-1179), from the corrected poses
        for a, b in loop_conns:
            if m.kf_valid[a] and m.kf_valid[b] and a < K and b < K:
                edges.append((a, b, 2.0, True))
        # earlier loops' edges (mspLoopEdges, Optimizer.cc:1270-1290)
        for a, b in m.loop_edges:
            if a < K and b < K and m.kf_valid[a] and m.kf_valid[b] and {a, b} != {kf1, kf2}:
                edges.append((a, b, 5.0, True))
        edges.append((kf2, kf1, 5.0, True))  # the loop edge
        E = len(edges)
        ECAP = 1 << (E - 1).bit_length()
        eye = np.eye(3, dtype=np.float32)
        R = np.broadcast_to(eye, (KCAP, 3, 3)).copy()
        t = np.zeros((KCAP, 3), np.float32)
        R[:K] = m.kf_R[:K]
        t[:K] = m.kf_t[:K]
        valid = np.zeros(KCAP, bool)
        valid[:K] = m.kf_valid[:K]
        # only the loop keyframe is fixed (Optimizer.cc:1117): it alone
        # anchors the gauge
        fixed = np.zeros(KCAP, bool)
        fixed[kf2] = True
        ei = np.zeros(ECAP, np.int64)
        ej = np.zeros(ECAP, np.int64)
        Rm = np.broadcast_to(eye, (ECAP, 3, 3)).copy()
        tm = np.zeros((ECAP, 3), np.float32)
        w = np.zeros(ECAP, np.float32)
        ev = np.zeros(ECAP, bool)
        s_node = np.ones(KCAP, np.float32)
        if group_scale != 1.0:
            s_node[[k for k in group if k < K]] = group_scale
        s_meas = np.ones(ECAP, np.float32)
        for n, (i, j, wt, use_cur) in enumerate(edges):
            ei[n], ej[n] = i, j
            Rs, ts_ = (m.kf_R, m.kf_t) if use_cur else (R_src, t_src)
            Rji = Rs[j].T
            tji = -Rji @ ts_[j]
            Rm[n] = Rs[i] @ Rji
            tm[n] = Rs[i] @ tji + ts_[i]
            if use_cur:
                # corrected poses are scale-folded SE3: the Sim3 relative
                # S_i ∘ S_j^-1 has scale s_i / s_j and translation s_i tm
                s_meas[n] = s_node[i] / s_node[j]
                tm[n] *= s_node[i]
            w[n] = wt
            ev[n] = True
        up = lambda a: torch.as_tensor(a, device=m.device)  # noqa: E731
        prob = pose_graph.PoseGraphProblem(
            R=up(R), t=up(t), fixed=up(fixed), valid=up(valid), ei=up(ei), ej=up(ej),
            R_meas=up(Rm), t_meas=up(tm), w=up(w), e_valid=up(ev))
        return prob, s_node, s_meas

    def _transport_landmarks(self, K, old_R, old_t, Rn, tn, sn, s_old=None):
        """Every landmark moved rigidly with its reference (first)
        keyframe's pose update. ``s_old``: the node scales before the solve
        (mono; the stored poses are scale-folded, so true camera
        coordinates are s_old (R x + t)). Caller holds the lock."""
        m = self.map
        if s_old is None:
            s_old = np.ones(K, np.float32)
        pids = m.point_ids()
        if len(pids):
            rk = np.clip(m.pt_first_kf[pids], 0, K - 1)
            pc = (np.einsum("nij,nj->ni", old_R[rk], m.pt_pos[pids]) + old_t[rk]) \
                * s_old[rk, None]
            m.pt_pos[pids] = np.einsum("nji,nj->ni", Rn[rk], (pc - tn[rk]) / sn[rk, None])
        lids = m.line_ids()
        if len(lids):
            rk = np.clip(m.ln_first_kf[lids], 0, K - 1)
            for i in (0, 1):
                pc = (np.einsum("nij,nj->ni", old_R[rk], m.ln_ep[lids, i]) + old_t[rk]) \
                    * s_old[rk, None]
                m.ln_ep[lids, i] = np.einsum("nji,nj->ni", Rn[rk], (pc - tn[rk]) / sn[rk, None])

    def _correct_appended_kfs(self, K, old_R, old_t):
        """Keyframes appended while a correction's solve ran still carry
        the pre-correction gauge: each is re-expressed against its anchor
        (its parent, or the last pre-correction keyframe), the reference's
        post-GBA spanning-tree propagation (LoopClosing.cc:1040-1090).
        Caller holds the lock."""
        m = self.map
        for k in range(K, m.n_kf):
            if not m.kf_valid[k]:
                continue
            a = int(m.kf_parent[k])
            if a < 0 or a >= K:
                a = K - 1
            while a > 0 and not m.kf_valid[a]:
                a -= 1
            # T_k_new = (T_k_old ∘ T_a_old^-1) ∘ T_a_new
            Rka = m.kf_R[k] @ old_R[a].T
            tka = m.kf_t[k] - Rka @ old_t[a]
            m.set_kf_pose(k, Rka @ m.kf_R[a], Rka @ m.kf_t[a] + tka)

    def _global_ba(self, kf1: int) -> str | None:
        """Full-map BA (RunGlobalBundleAdjustment, LoopClosing.cc:972-1119)
        through the local mapper's gatherer, with a window over every
        keyframe and caps that scale with the map. Returns the solver that
        ran ("dense" or "pcg"), or None."""
        if self.local_mapper is None:
            return None
        m = self.map
        caps = global_ba_caps(m)
        with self.lock:
            K = m.n_kf
            old_R = m.kf_R[:K].copy()
            old_t = m.kf_t[:K].copy()
        solver = self.local_mapper.run_local_ba(kf1, max_kf=K, **caps)
        with self.lock:
            # keyframes created while GBA iterated ride along via their anchors
            self._correct_appended_kfs(K, old_R, old_t)
        return solver
