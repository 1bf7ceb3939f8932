"""Frontend tracking: the per-frame state machine and its device step.

The reference ``Tracking`` thread (Tracking.cc) as a host-side state
machine around one device step per frame (``fused_track_step``), for the
RGB-D, stereo and monocular sensors:

- Frame construction (Frame.cc RGB-D ctor — perception),
- TrackWithMotionModel (:1212-1330) + UpdateLastFrame temporal landmarks
  (:1044-1210, closest-100/45 caps) + the x2-radius retry (:1255-1259),
- the TrackReferenceKeyFrame-equivalent rescue (:335-337, :942-1032),
- TrackLocalMap (:1332-1420) + SearchLocalPoints/Lines (:1746-1865) +
  IsInFrustum (Frame.cc:345-430), with joint point+line pose LM after each.

Frame-to-frame state (previous FrameData, pose, velocity, landmark
bindings) stays on the device; the host copies one small result record per
frame. Local-map tensors are uploaded only when the keyframe set changes.

The device step takes optional leading batch axes: B trackers that share a
configuration run one step for their B frames (parallel.multiseq), which
hands each tracker its slice through ``process(precomputed_out=...)``. An
unbatched step runs the same operations without the axis.

Keyframe decision/creation follows NeedNewKeyFrame / CreateNewKeyFrame
(:1423-1744): close-point bookkeeping, depth-sorted new landmark creation,
line creation from endpoint depths.

Stereo (``process_stereo``) builds each frame from the pair
(``frame.build_frame_stereo``: depth from the left-right match, no lines)
and otherwise tracks as RGB-D. Monocular (``process_mono``) runs the same
step on an all-zero depth map: the map is bootstrapped from two views
(``_monocular_initialization``: ``mono_init_match``, the H / F RANSAC of
ops.initializer, a two-keyframe map scaled to median depth 1) and grows by
the local mapper's epipolar triangulation.

A local mapper (models.local_mapping, or its worker-thread wrapper in
models.async_mapping) receives every new keyframe; its lock, when it has
one, guards the tracker's map bookkeeping (Map::mMutexMapUpdate). Without
one (``local_mapper=None``) keyframes still mint landmarks from depth and
the local map is still harvested from covisibility.

With a vocabulary and a keyframe database (``voc`` / ``kfdb``) every
keyframe registers its bag of words, and a LOST tracker relocalizes
(models/relocalization.py) behind a speed-scaled short-lost gate.
Localization-only mode (``only_tracking``, the reference's mbOnlyTracking)
mints no keyframe and, when map matches starve while the motion stage's
temporal points still carry the pose, keeps tracking as visual odometry
(``vo_mode``, mbVO) and retries relocalization every second frame until
the map is reacquired. A loop closer (models.loop_closing, or its worker
in models.async_mapping) receives every keyframe after its bag of words;
the corrections it makes reach this tracker through the gauge-correction
protocol (``apply_gauge_correction``). With a ``tracer``
(utils.tracing) every retired frame writes a "frame" record and every
relocalization a "reloc" record, with the JAX package's fields; while the
recorder of utils.tracing is on, the frame, its stages, its host syncs and
its map-lock waits are recorded as spans, and the frames handled in LOST
and the relocalizations taken are counted.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..bow.vocabulary import sparse_bow
from ..config import SlamConfig
from ..geometry import lines as glines
from ..geometry import projection as gproj
from ..geometry import se3
from ..ops import initializer as mono_init_ops
from ..ops import line_matching, matching
from ..ops.batch import take_rows
from ..optim import pose as pose_opt
from ..utils import tracing
from . import frame as mframe
from . import relocalization
from .frame import FrameData
from .map import HostFrame, SlamMap

TH_HIGH = 100
TH_LOW = 50


def _inv_sigma2(octave, scale: float):
    return (1.0 / scale**2) ** octave.float()


def _project_points(cam, R, t, p3d):
    pc = se3.apply(R, t, p3d)
    z = pc[..., 2]
    safe = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * pc[..., 0] / safe + cam.cx
    v = cam.fy * pc[..., 1] / safe + cam.cy
    uv = torch.stack([u, v], -1)
    in_img = (z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return uv, pc, in_img


def _assemble_pose_obs(cfg, fd: FrameData, q_p3d, q_valid, pt_idx, pt_ok,
                       ln_ep3d, ln_valid, ln_idx, ln_ok):
    """Gather matched observations into fixed-shape PoseObs."""
    scale = cfg.orb.scale_factor
    idx = pt_idx.long().clamp(0, fd.kp_xy_un.shape[-2] - 1)
    lidx = ln_idx.long().clamp(0, fd.ln_ep_un.shape[-3] - 1)
    nw, vw = glines.plucker_from_endpoints(ln_ep3d[..., 0, :], ln_ep3d[..., 1, :])
    return pose_opt.PoseObs(
        p3d=q_p3d, uv=take_rows(fd.kp_xy_un, idx), u_right=take_rows(fd.kp_ur, idx),
        inv_sigma2=_inv_sigma2(take_rows(fd.kp_octave, idx), scale), valid=pt_ok & q_valid,
        line_nw=nw, line_vw=vw, line_uv=take_rows(fd.ln_ep_un, lidx),
        line_inv_sigma2=torch.ones(ln_ep3d.shape[:-2], dtype=torch.float32,
                                   device=ln_ep3d.device),
        line_valid=ln_ok & ln_valid,
    )


def _scatter_set(n: int, idx, ok, src):
    """out = full(n, -1); out[idx[ok]] = src[ok] (indices unique where ok),
    per batch entry. Rows not ok land in a spare slot that is cut off: no
    host sync."""
    out = torch.full(idx.shape[:-1] + (n + 1,), -1, dtype=torch.int32, device=src.device)
    tgt = torch.where(ok, idx.long(), torch.full_like(idx, n, dtype=torch.int64))
    return out.scatter_(-1, tgt, src.to(torch.int32).expand(tgt.shape))[..., :n]


# ===========================================================================
# Step cores
# ===========================================================================


class MotionStepOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    pt_idx: torch.Tensor
    pt_inlier: torch.Tensor
    ln_idx: torch.Tensor
    ln_inlier: torch.Tensor
    n_pt_matches: torch.Tensor
    n_inliers: torch.Tensor


def _motion_core(cfg, fd, q_p3d, q_desc, q_octave, q_angle, q_valid,
                 ln_ep3d, ln_desc, ln_valid, R_guess, t_guess) -> MotionStepOut:
    cam = cfg.camera
    scale = cfg.orb.scale_factor
    with tracing.span("match"):
        uv_proj, _, in_img = _project_points(cam, R_guess, t_guess, q_p3d)
        q_ok = q_valid & in_img
        sf = scale ** q_octave.float()

        def run_match(radius_mult):
            radius = cfg.matcher.search_radius_motion * radius_mult * sf
            gate = (
                matching.window_gate(uv_proj, fd.kp_xy_un, radius)
                & matching.octave_gate(q_octave, fd.kp_octave, -1, 1)
                & q_ok[..., :, None]
                & fd.kp_valid[..., None, :]
            )
            return matching.match_descriptors(
                q_desc, fd.kp_desc, gate, TH_HIGH,
                angle_q=q_angle, angle_t=fd.kp_angle,
                histo_length=cfg.matcher.histo_length,
            )

        m1 = run_match(1.0)
        m2 = run_match(2.0)
        use_wide = (m1.count < 20)[..., None]
        m = matching.MatchResult(*(torch.where(use_wide, b, a) for a, b in zip(m1, m2)))

        proj = line_matching.project_lines(cam, R_guess, t_guess, ln_ep3d, ln_valid)
        lm = line_matching.match_lines(
            proj, ln_desc, fd.ln_ep_un, fd.ln_angle, fd.ln_length,
            fd.ln_desc, fd.ln_valid, cfg.lines,
        )

    obs = _assemble_pose_obs(cfg, fd, q_p3d, q_valid, m.idx, m.ok,
                             ln_ep3d, ln_valid, lm.idx, lm.ok)
    res = pose_opt.optimize_pose(cam, R_guess, t_guess, obs)
    return MotionStepOut(
        res.R, res.t, m.idx, m.ok & res.inlier_pts, lm.idx,
        lm.ok & res.inlier_lines, m.count, res.n_inliers,
    )


class LocalStepOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    pt_idx: torch.Tensor      # (LM,) final matched feature per local map point
    pt_inlier: torch.Tensor   # (LM,)
    ln_idx: torch.Tensor
    ln_inlier: torch.Tensor
    pt_visible: torch.Tensor  # (LM,) frustum-visible mask (for found/visible)
    n_inliers: torch.Tensor


def _local_core(cfg, fd, lm_p3d, lm_desc, lm_normal, lm_mind, lm_maxd,
                lm_valid, lm_pre_feat, lml_ep3d, lml_desc, lml_valid,
                lml_pre_feat, R0, t0) -> LocalStepOut:
    cam = cfg.camera
    scale = cfg.orb.scale_factor
    n_levels = cfg.orb.n_levels

    with tracing.span("match"):
        uv_proj, pc, in_img = _project_points(cam, R0, t0, lm_p3d)
        # IsInFrustum (Frame.cc:345-401): distance band + viewing angle
        _, cam_center = se3.inverse(R0, t0)
        po = lm_p3d - cam_center[..., None, :]
        dist = torch.linalg.vector_norm(po, dim=-1)
        dist_ok = (dist >= 0.8 * lm_mind) & (dist <= 1.2 * lm_maxd)
        view_cos = (po * lm_normal).sum(-1) / (
            dist * torch.linalg.vector_norm(lm_normal, dim=-1)).clamp(min=1e-6)
        view_ok = view_cos > 0.5
        pre_matched = lm_pre_feat >= 0
        # ALL visible points are re-matched (not only the ones the motion step
        # left unbound): motion-step bindings were selected at a possibly biased
        # pose, and freezing them feeds that bias forward
        visible = lm_valid & in_img & dist_ok & view_ok

        ratio = torch.log(lm_maxd.clamp(min=1e-6) / dist.clamp(min=1e-6))
        pred_level = torch.ceil(ratio / float(np.log(np.float32(scale)))).to(
            torch.int32).clamp(0, n_levels - 1)
        base_r = torch.where(view_cos > 0.998, 2.5, 4.0)
        radius = cfg.matcher.search_radius_local * base_r * scale ** pred_level.float()

        gate = (
            matching.window_gate(uv_proj, fd.kp_xy_un, radius)
            & matching.octave_gate(pred_level, fd.kp_octave, -1, 0)
            & visible[..., :, None]
            & fd.kp_valid[..., None, :]
        )
        m = matching.match_descriptors(
            lm_desc, fd.kp_desc, gate, TH_HIGH,
            nn_ratio=cfg.matcher.nn_ratio_tracking, dedupe=True,
        )
        # combine fresh matches with motion-step bindings, then RE-DEDUPE: the
        # fallback can route several duplicate landmarks onto one feature
        pt_idx = torch.where(m.ok, m.idx, lm_pre_feat)
        pt_ok = m.ok | pre_matched
        comb_dist = torch.where(m.ok, m.dist, torch.full_like(m.dist, 300))  # fresh wins ties
        comb = matching.dedupe_targets(
            matching._masked(pt_ok, pt_idx, comb_dist), fd.kp_desc.shape[-2])
        pt_idx, pt_ok = comb.idx, comb.ok

        lproj = line_matching.project_lines(cam, R0, t0, lml_ep3d, lml_valid)
        ln_pre = lml_pre_feat >= 0
        lm_res = line_matching.match_lines(
            lproj, lml_desc, fd.ln_ep_un, fd.ln_angle, fd.ln_length, fd.ln_desc,
            fd.ln_valid, cfg.lines,
        )
        ln_idx = torch.where(lm_res.ok, lm_res.idx, lml_pre_feat)
        ln_ok = lm_res.ok | ln_pre
        ln_dist = torch.where(lm_res.ok, lm_res.dist, torch.full_like(lm_res.dist, 300))
        lcomb = matching.dedupe_targets(
            matching._masked(ln_ok, ln_idx, ln_dist), fd.ln_desc.shape[-2])
        ln_idx, ln_ok = lcomb.idx, lcomb.ok

    obs = _assemble_pose_obs(cfg, fd, lm_p3d, lm_valid, pt_idx, pt_ok,
                             lml_ep3d, lml_valid, ln_idx, ln_ok)
    res = pose_opt.optimize_pose(cam, R0, t0, obs)
    return LocalStepOut(
        res.R, res.t, pt_idx, pt_ok & res.inlier_pts, ln_idx,
        ln_ok & res.inlier_lines, visible | pre_matched, res.n_inliers,
    )


# ===========================================================================
# Fused per-frame step
# ===========================================================================


class FusedOut(NamedTuple):
    fd: FrameData                # stays on device as next frame's "prev"
    R: torch.Tensor
    t: torch.Tensor
    R_vel: torch.Tensor
    t_vel: torch.Tensor
    feat_slot_pt: torch.Tensor   # (N,) local-map slot bound to each cur feature
    feat_slot_ln: torch.Tensor   # (NL,)
    lm_feat: torch.Tensor        # (LM,) matched cur feature per slot (-1)
    lm_inlier: torch.Tensor      # (LM,)
    lm_visible: torch.Tensor     # (LM,)
    lml_feat: torch.Tensor       # (LL,)
    lml_inlier: torch.Tensor
    stats: torch.Tensor          # (6,) int32: [n_motion_matches,
                                 # n_track_inliers (motion or rescue),
                                 # n_local_inliers, tracked_close,
                                 # creatable_close, n_rescue_inliers (0 when
                                 # the rescue stage didn't fire/win)]


def _kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(x).values[..., k - 1]


def _rescue_core(cfg, fd, lm_p3d, lm_desc, lm_valid, lml_ep3d, lml_valid, R_prev, t_prev):
    """TrackReferenceKeyFrame equivalent (Tracking.cc:335-337,942-1032): the
    LOCAL MAP's descriptors against the whole frame with NO spatial window,
    then the pose LM from the LAST pose. Returns (MatchResult, PoseResult)."""
    with tracing.span("match"):
        gate = lm_valid[..., :, None] & fd.kp_valid[..., None, :]
        m = matching.match_descriptors(
            lm_desc, fd.kp_desc, gate, TH_LOW,
            nn_ratio=cfg.matcher.nn_ratio_reloc, dedupe=True)
    obs = _assemble_pose_obs(
        cfg, fd, lm_p3d, lm_valid, m.idx, m.ok, lml_ep3d, lml_valid,
        torch.zeros(lml_valid.shape, dtype=torch.int32, device=lml_valid.device),
        torch.zeros(lml_valid.shape, dtype=torch.bool, device=lml_valid.device))
    return m, pose_opt.optimize_pose(cfg.camera, R_prev, t_prev, obs)


def fused_track_step(
    cfg: SlamConfig,
    gray: torch.Tensor,        # quantized gray (TrackingConfig.gray_wire_bits)
    depth: torch.Tensor,       # depth map, integer depth_map_factor units
    prev: FrameData,
    prev_slot_pt: torch.Tensor,  # (N,) lm slot per prev feature or -1
    prev_slot_ln: torch.Tensor,  # (NL,)
    pt_remap: torch.Tensor,      # (LM,) old-slot -> current-slot (identity
    ln_remap: torch.Tensor,      # (LL,)  when the local map didn't change)
    R_prev: torch.Tensor,
    t_prev: torch.Tensor,
    R_vel: torch.Tensor,
    t_vel: torch.Tensor,
    has_vel,                     # bool, or a bool tensor with the batch's axes
    lm_p3d, lm_desc, lm_normal, lm_mind, lm_maxd, lm_valid,
    lml_ep3d, lml_desc, lml_valid,
    stereo: bool = False,
) -> FusedOut:
    """One tracked frame on the device. ``depth`` is the depth map, or with
    ``stereo=True`` the quantized RIGHT image.

    With a leading batch axis on every tensor (``gray`` (B, H, W), ``prev``
    and the local map stacked, ``has_vel`` a (B,) bool tensor) it tracks B
    independent sequences in one step: each hand kernel launches once for
    all B, and row b of every output equals the step of sequence b alone."""
    cam = cfg.camera
    dev = lm_p3d.device
    batched = gray.dim() == 3
    LM = lm_p3d.shape[-2]
    LL = lml_ep3d.shape[-3]
    neg = lambda x: torch.full_like(x, -1)  # noqa: E731
    prev_slot_pt = torch.where(
        prev_slot_pt >= 0, take_rows(pt_remap, prev_slot_pt.long().clamp(0, LM - 1)),
        neg(prev_slot_pt))
    prev_slot_ln = torch.where(
        prev_slot_ln >= 0, take_rows(ln_remap, prev_slot_ln.long().clamp(0, LL - 1)),
        neg(prev_slot_ln))

    with tracing.span("track.perception"):
        fd = (mframe.build_frame_stereo(gray, depth, cfg, quantized=True) if stereo
              else mframe.build_frame(gray, depth, cfg, quantized=True))

    with tracing.span("track.motion"):
        # velocity-model pose guess (jnp.where on a traced flag in the JAX package)
        has_vel = torch.as_tensor(has_vel, dtype=torch.bool, device=dev)
        Rc, tc = se3.compose(R_vel, t_vel, R_prev, t_prev)
        Rg = torch.where(has_vel[..., None, None], Rc, R_prev)
        tg = torch.where(has_vel[..., None], tc, t_prev)

        # ---- queries from the previous frame -------------------------------
        Rwc, c_prev = se3.inverse(R_prev, t_prev)
        slot = prev_slot_pt.long().clamp(0, LM - 1)
        bound = (prev_slot_pt >= 0) & take_rows(lm_valid, slot)
        p_map = take_rows(lm_p3d, slot)
        pc_prev = gproj.backproject(cam, prev.kp_xy_un, prev.kp_depth)
        p_temp = se3.apply(Rwc, c_prev, pc_prev)
        has_d = prev.kp_depth > 0
        t_cand = prev.kp_valid & has_d & ~bound
        # UpdateLastFrame (Tracking.cc:1044-1210): ALL close points (depth <
        # ThDepth) become temporal candidates, with the closest-``cap`` as a
        # floor when close points are scarce
        cap = cfg.tracking.temporal_points_cap
        dsel = torch.where(t_cand, prev.kp_depth, torch.full_like(prev.kp_depth, float("inf")))
        kth = _kth_smallest(dsel, cap)[..., None]
        t_sel = t_cand & ((dsel <= kth) | (dsel <= cfg.tracking.th_depth))
        q_p3d = torch.where(bound[..., None], p_map, p_temp)
        q_valid = bound | t_sel

        lslot = prev_slot_ln.long().clamp(0, LL - 1)
        lbound = (prev_slot_ln >= 0) & take_rows(lml_valid, lslot)
        l_map = take_rows(lml_ep3d, lslot)
        l_temp = torch.stack(
            [se3.apply(Rwc, c_prev, gproj.backproject(cam, prev.ln_ep_un[..., k, :],
                                                      prev.ln_depth[..., k]))
             for k in (0, 1)],
            dim=-2,
        )
        lt_cand = prev.ln_valid & (prev.ln_depth > 0).all(-1) & ~lbound
        lcap = cfg.tracking.temporal_lines_cap
        ldsel = torch.where(lt_cand, prev.ln_depth.amax(-1),
                            torch.full_like(prev.ln_depth[..., 0], float("inf")))
        lkth = _kth_smallest(ldsel, lcap)[..., None]
        lt_sel = lt_cand & ((ldsel <= lkth) | (ldsel <= cfg.tracking.th_depth))
        l_ep3d = torch.where(lbound[..., None, None], l_map, l_temp)
        l_valid = lbound | lt_sel

        # ---- motion step ----------------------------------------------------
        mo = _motion_core(cfg, fd, q_p3d, prev.kp_desc, prev.kp_octave,
                          prev.kp_angle, q_valid, l_ep3d, prev.ln_desc, l_valid,
                          Rg, tg)

        # pre-bindings for the local step: slot -> matched cur feature
        pre_feat = _scatter_set(LM, slot, bound & mo.pt_inlier, mo.pt_idx)
        lpre_feat = _scatter_set(LL, lslot, lbound & mo.ln_inlier, mo.ln_idx)
    R_mid, t_mid = mo.R, mo.t
    n_track = mo.n_inliers.to(torch.int32)
    n_rescue = torch.zeros_like(n_track)

    # ---- rescue step ----------------------------------------------------
    # when the motion stage starves, the windowless local-map match
    # (_rescue_core) takes the frame if it finds more inliers. One host read
    # of the B motion-inlier counts per step keeps it off the common path;
    # it runs once, on the sequences that need it, and its results are
    # written back to their rows.
    with tracing.span("sync.rescue"):
        mo_n = mo.n_inliers.reshape(-1).tolist()
    rows = [b for b, n in enumerate(mo_n) if n < cfg.tracking.rescue_min_inliers]
    if rows:
        tracing.count("track.rescue.rows", len(rows))
        with tracing.span("track.rescue"):
            if batched and len(rows) < len(mo_n):
                sub = torch.as_tensor(rows, device=dev)
                pick = lambda x: x.index_select(0, sub)  # noqa: E731
            else:
                pick = lambda x: x  # noqa: E731
            m, res = _rescue_core(cfg, FrameData(*map(pick, fd)), pick(lm_p3d), pick(lm_desc),
                                  pick(lm_valid), pick(lml_ep3d), pick(lml_valid),
                                  pick(R_prev), pick(t_prev))
            with tracing.span("sync.rescue"):
                r_n = res.n_inliers.reshape(-1).tolist()
            won = [j for j, n in enumerate(r_n) if n > mo_n[rows[j]]]
            if won:
                tracing.count("track.rescue.won", len(won))
                if batched:
                    dst = torch.as_tensor([rows[j] for j in won], device=dev)
                    src = torch.as_tensor(won, device=dev)
                    put = lambda full, part: full.index_copy(  # noqa: E731
                        0, dst, part.index_select(0, src))
                else:
                    put = lambda full, part: part  # noqa: E731
                pre_feat = put(pre_feat, torch.where(m.ok & res.inlier_pts, m.idx, neg(m.idx)))
                lpre_feat = put(lpre_feat, torch.full(res.inlier_lines.shape, -1, dtype=torch.int32,
                                                      device=dev))
                R_mid, t_mid = put(R_mid, res.R), put(t_mid, res.t)
                n_track = put(n_track, res.n_inliers.to(torch.int32))
                n_rescue = put(n_rescue, res.n_inliers.to(torch.int32))

    # ---- local-map step -------------------------------------------------
    with tracing.span("track.local"):
        lo = _local_core(cfg, fd, lm_p3d, lm_desc, lm_normal, lm_mind, lm_maxd,
                         lm_valid, pre_feat, lml_ep3d, lml_desc, lml_valid,
                         lpre_feat, R_mid, t_mid)
    # trust the local-map refinement only when it has real support
    use_local = lo.n_inliers >= cfg.tracking.min_inliers_local_map
    R_fin = torch.where(use_local[..., None, None], lo.R, R_mid)
    t_fin = torch.where(use_local[..., None], lo.t, t_mid)

    ok_slot = lo.pt_inlier & (lo.pt_idx >= 0)
    n = fd.kp_valid.shape[-1]
    lm_ids = torch.arange(LM, dtype=torch.int32, device=dev)
    feat_slot_pt = _scatter_set(n, lo.pt_idx, ok_slot, lm_ids)
    nl = fd.ln_valid.shape[-1]
    lok_slot = lo.ln_inlier & (lo.ln_idx >= 0)
    feat_slot_ln = _scatter_set(nl, lo.ln_idx, lok_slot,
                                torch.arange(LL, dtype=torch.int32, device=dev))

    # velocity for next frame: T_cur ∘ T_prev^-1
    Rpi, tpi = se3.inverse(R_prev, t_prev)
    Rvn, tvn = se3.compose(R_fin, t_fin, Rpi, tpi)

    # close-point stats for the keyframe decision (NeedNewKeyFrame)
    close = fd.kp_valid & (fd.kp_depth > 0) & (fd.kp_depth < cfg.tracking.th_depth)
    tracked_close = (close & (feat_slot_pt >= 0)).sum(-1, dtype=torch.int32)
    creatable_close = (close & (feat_slot_pt < 0)).sum(-1, dtype=torch.int32)

    return FusedOut(
        fd=fd, R=R_fin, t=t_fin, R_vel=Rvn, t_vel=tvn,
        feat_slot_pt=feat_slot_pt, feat_slot_ln=feat_slot_ln,
        lm_feat=torch.where(ok_slot, lo.pt_idx, neg(lo.pt_idx)), lm_inlier=ok_slot,
        lm_visible=lo.pt_visible,
        lml_feat=torch.where(lok_slot, lo.ln_idx, neg(lo.ln_idx)), lml_inlier=lok_slot,
        stats=torch.stack([
            mo.n_pt_matches.to(torch.int32), n_track,
            lo.n_inliers.to(torch.int32), tracked_close, creatable_close, n_rescue,
        ], -1),
    )


def _record_tensors(out: FusedOut) -> list[torch.Tensor]:
    """The fields of a step that its retirement (``Tracker._finish``) reads
    on the host."""
    fd = out.fd
    return [out.stats, out.R, out.t, out.lm_feat, out.lm_inlier, out.lm_visible,
            out.lml_feat, out.lml_inlier, fd.kp_xy_un, fd.kp_octave, fd.kp_depth,
            fd.kp_valid, fd.ln_ep_un, fd.ln_desc, fd.ln_depth, fd.ln_valid]


class BatchRecord:
    """The retirement fields of a batched step (leading axis B), copied to
    the host in ONE transfer for all B sequences at the first read; ``row(b)``
    is sequence b's, as ``_to_host`` of its own step would give it."""

    def __init__(self, out: FusedOut):
        self._tensors = _record_tensors(out)
        self._host: list[np.ndarray] | None = None

    def row(self, b: int) -> list[np.ndarray]:
        if self._host is None:
            self._host = _to_host(self._tensors)
            self._tensors = None
        return [h[b] for h in self._host]


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Copy several device tensors to host numpy in ONE transfer: their
    bytes are packed into one uint8 buffer on the device first."""
    flat = [t.contiguous().reshape(-1) for t in tensors]
    buf = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel() * f.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(buf[off:off + nbytes].view(dtype).reshape(tuple(t.shape)))
        off += nbytes
    return out


def mono_init_match(cfg: SlamConfig, q_xy, q_desc, q_valid, t_xy, t_desc, t_valid):
    """SearchForInitialization (ORBmatcher.cc:573-727): a 100 px window,
    ratio 0.9, TH_LOW, deduped, as one gated search. Returns (idx, ok)."""
    gate = (matching.window_gate(q_xy, t_xy, torch.full((q_xy.shape[0],), 100.0,
                                                         device=q_xy.device))
            & q_valid[:, None] & t_valid[None, :])
    m = matching.match_descriptors(q_desc, t_desc, gate, TH_LOW, nn_ratio=0.9, dedupe=True)
    return m.idx, m.ok


# ===========================================================================
# Host-side tracker
# ===========================================================================

NOT_INITIALIZED = 0
OK = 1
LOST = 2
SENSORS = ("rgbd", "stereo", "mono")  # System eSensor (System.h:58-66)


class Tracker:
    """Host state machine driving the fused device step and the map."""

    LM_CAP = 8192
    LL_CAP = 512
    # max frames between local-map harvests when no keyframe event fires
    REFRESH_MAX_FRAMES = 12

    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, local_mapper=None,
                 loop_closer=None, voc=None, kfdb=None, sensor: str = "rgbd",
                 tracer=None):
        if sensor not in SENSORS:
            raise ValueError(f"sensor={sensor!r}: one of {SENSORS}")
        self.cfg = cfg
        self.map = slam_map
        self.device = slam_map.device
        self.sensor = sensor  # System eSensor
        # the monocular bootstrap's held reference frame (fd, HostFrame,
        # timestamp); None until one is held and again after a bootstrap
        self._mono_ref = None
        # the last bootstrap attempt that reached a reconstruction: its
        # frame, the H and F scores, and whether the winner was clear
        self.mono_init_stats: dict | None = None
        self.local_mapper = local_mapper
        # map-update lock (Map::mMutexMapUpdate) of a mapper on a worker
        # thread; a no-op without one
        self._map_lock = getattr(local_mapper, "lock", None) or contextlib.nullcontext()
        self.loop_closer = loop_closer
        self.voc = voc
        self.kfdb = kfdb
        # structured JSONL records "frame" and "reloc" (utils.tracing)
        self.tracer = tracer or tracing.NULL
        # the index of this tracker's sequence in a MultiTracker, which sets
        # it; the recorder's spans carry it (utils.tracing)
        self.session: int | None = None
        self.state = NOT_INITIALIZED
        self.frame_id = -1
        self.last_kf_id = -1
        self.last_kf = -1
        self.ref_kf = -1
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        # per frame (ref_kf, R_cr, t_cr): the pose relative to its reference
        # keyframe (Tracking.cc:578-597 mlRelativeFramePoses); composed with
        # the keyframe's current pose it heals the trajectory after local BA
        # moves keyframes (healed_trajectory)
        self.traj_refs: list[tuple[int, np.ndarray, np.ndarray]] = []
        self.n_lost_frames = 0
        self.only_tracking = False  # localization-only mode (mbOnlyTracking)
        # visual-odometry mode inside localization-only tracking (mbVO,
        # Tracking.cc:344-445): map matches starved, the pose carried by
        # temporal points; relocalization retries until the map is reacquired
        self.vo_mode = False
        # camera-centre displacement per frame while tracking is confident
        # (metres, a decayed max, see _finish): scales the short-lost
        # relocalization gate. None until two retired poses exist
        self._speed_est: float | None = None
        self.debug: dict = {}
        dev = self.device
        # device-resident state
        self._prev_fd: FrameData | None = None
        self._prev_slot_pt = None
        self._prev_slot_ln = None
        self._R = None
        self._t = None
        self._R_vel = torch.eye(3, dtype=torch.float32, device=dev)
        self._t_vel = torch.zeros(3, dtype=torch.float32, device=dev)
        self._has_vel = False
        # cached local map (device tensors + host id tables)
        self._lm_args = None
        self._lp_ids = np.zeros(0, np.int32)
        self._ll_ids = np.zeros(0, np.int32)
        self._refresh_frame = -1  # frame id of the last local-map harvest
        self._refresh_inl = 0     # inlier baseline at that harvest
        # host mirrors for the current/last frame
        self.last_pose: tuple[np.ndarray, np.ndarray] | None = None
        self.last_pt_ids: np.ndarray | None = None
        self.last_ln_ids: np.ndarray | None = None
        # frames in flight before a result is retired (0 = auto = 1: a local
        # device has no fetch latency to hide)
        self.pipeline_depth = cfg.tracking.pipeline_depth or 1
        self._queue: list[dict] = []
        # gauge-correction protocol (loop closing, GBA): a correction
        # rewrites keyframe poses while this tracker, and frames in flight,
        # still live in the pre-correction gauge. The corrector publishes
        # the rigid delta D = T_kf_old^-1 ∘ T_kf_new under the map lock
        # (apply_gauge_correction); the tracker thread applies it at its
        # next process() (device pose right-composed with D, local map
        # re-uploaded), and frames dispatched before it have their poses
        # composed with every delta since their dispatch when they retire
        # (epoch). The reference stalls Tracking on Map::mMutexMapUpdate
        # for the whole correction instead.
        self._pending_gauge: tuple[np.ndarray, np.ndarray] | None = None
        self._corr_epoch = 0
        self._corr_deltas: list[tuple[np.ndarray, np.ndarray]] = []
        self._id_pt = torch.arange(self.LM_CAP, dtype=torch.int32, device=dev)
        self._id_ln = torch.arange(self.LL_CAP, dtype=torch.int32, device=dev)
        self._pt_remap = self._id_pt
        self._ln_remap = self._id_ln
        self._pt_remap_np = None
        self._ln_remap_np = None

    # ------------------------------------------------------------------ API
    def process(self, gray: np.ndarray, depth: np.ndarray, timestamp: float,
                precomputed_out: FusedOut | None = None, host_record=None):
        """Track one RGB-D frame (uint8 or float gray; uint16 depth in
        depth_map_factor units, or float metres); for a stereo tracker
        ``depth`` is the right image (``process_stereo``).

        Pipelined lag-1: returns the PREVIOUS frame's (R, t) world-to-camera
        (or None). Call :meth:`flush` to drain the last in-flight frame.

        ``precomputed_out``: this frame's step, computed outside (the
        batched multi-sequence frontend, parallel.multiseq, runs one step for
        B trackers in OK state after calling their :meth:`begin_frame`, and
        hands each its slice; the images are then not read);
        ``host_record``: a callable returning that step's retirement fields
        on the host (a row of ``BatchRecord``)."""
        frame = self.frame_id if precomputed_out is not None else self.frame_id + 1
        with tracing.span("track.frame", frame=frame, session=self.session):
            if precomputed_out is not None:
                if self.state != OK:
                    raise RuntimeError("a precomputed step needs a tracker in OK state")
                return self._track(None, None, timestamp, precomputed_out, host_record)
            self.begin_frame()
            gray, depth = self._inputs_to_device(gray, depth)
            if self.state == NOT_INITIALIZED:
                init = (self._monocular_initialization if self.sensor == "mono"
                        else self._stereo_initialization)
                if init(self._build_frame(gray, depth), timestamp):
                    self.state = OK
                    return self.last_pose
                return None
            if self.state == LOST:
                tracing.count("track.lost")
                self._prev_fd = self._build_frame(gray, depth)
                if self._try_relocalize(timestamp):
                    return self.last_pose
                # reference: reset if lost right after init (Tracking.cc:560-568)
                if self.map.n_kf <= self.cfg.tracking.reset_if_lost_with_kfs_leq \
                        and self.n_lost_frames > 20:
                    self.reset()
                self.n_lost_frames += 1
                return None
            return self._track(gray, depth, timestamp)

    def begin_frame(self):
        """Count a new frame and do what the tracker owes before its step is
        dispatched: apply a published gauge correction, and in VO mode retry
        relocalization every second frame. ``process`` calls it; the batched
        frontend calls it before it reads ``dispatch_args``."""
        self.frame_id += 1
        if self.state == OK and self._pending_gauge is not None:
            self._apply_pending_gauge()
        if self.state == OK and self.vo_mode and self.frame_id % 2 == 0:
            self._try_reacquire_map()

    def _inputs_to_device(self, gray, depth):
        """Quantized inputs (``_quantize_inputs``) as device tensors."""
        gray, depth = self._quantize_inputs(gray, depth)
        if self.sensor != "stereo":
            depth = depth.astype(np.int32)
        with tracing.span("sync.upload"):
            return torch.from_numpy(gray).to(self.device), torch.from_numpy(depth).to(self.device)

    def _track(self, gray, depth, timestamp, out=None, host_record=None):
        """OK state: dispatch this frame (or take its precomputed step), then
        retire the oldest in-flight one."""
        out = self._dispatch(gray, depth, out=out)
        result = None
        if len(self._queue) >= self.pipeline_depth:
            pending = self._queue.pop(0)
            if self._finish(pending):
                result = self.last_pose
                self.n_lost_frames = 0
            else:
                # an old frame failed: every newer dispatch used its bad pose —
                # discard them all, keep this frame's perception
                self._queue.clear()
                self.n_lost_frames += 1
                self.state = LOST
                tracing.count("track.lost")
                self._prev_slot_pt = torch.full_like(self._prev_slot_pt, -1)
                self._prev_slot_ln = torch.full_like(self._prev_slot_ln, -1)
                self._has_vel = False
                if self._try_relocalize(timestamp):
                    return self.last_pose
                return None
        self._queue.append(dict(
            out=out, host=host_record, timestamp=timestamp, frame_id=self.frame_id,
            lp_ids=self._lp_ids, ll_ids=self._ll_ids, epoch=self._corr_epoch,
        ))
        return result

    def process_mono(self, gray: np.ndarray, timestamp: float):
        """Track one monocular frame (System::TrackMonocular ->
        GrabImageMonocular, Tracking.cc:244-281): the shared step on an
        all-zero half-res depth map, so no temporal point has depth and
        landmarks come from the bootstrap and epipolar triangulation."""
        if self.sensor != "mono":
            raise RuntimeError(f"process_mono on a {self.sensor} tracker")
        h, w = self.cfg.camera.height // 2, self.cfg.camera.width // 2
        return self.process(gray, np.zeros((h, w), np.uint16), timestamp)

    def process_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray, timestamp: float):
        """Track one rectified stereo pair (System::TrackStereo ->
        GrabImageStereo, Tracking.cc:170-208)."""
        if self.sensor != "stereo":
            raise RuntimeError(f"process_stereo on a {self.sensor} tracker")
        return self.process(gray_l, gray_r, timestamp)

    def _build_frame(self, gray: torch.Tensor, depth: torch.Tensor) -> FrameData:
        """This sensor's FrameData of quantized inputs (``depth``: the right
        image for stereo)."""
        if self.sensor == "stereo":
            return mframe.build_frame_stereo(gray, depth, self.cfg, quantized=True)
        return mframe.build_frame(gray, depth, self.cfg, quantized=True)

    def apply_gauge_correction(self, R_delta, t_delta):
        """Publish a rigid gauge delta (T_old^-1 ∘ T_new of a corrected
        anchor keyframe) for the tracker thread to apply at its next frame.
        Called by the loop closer, possibly from its worker, under the map
        lock; a delta not yet consumed composes: D = D_prev ∘ D_new."""
        R_delta = np.asarray(R_delta, np.float32)
        t_delta = np.asarray(t_delta, np.float32)
        if self._pending_gauge is None:
            self._pending_gauge = (R_delta, t_delta)
        else:
            Rp, tp = self._pending_gauge
            self._pending_gauge = ((Rp @ R_delta).astype(np.float32),
                                   (Rp @ t_delta + tp).astype(np.float32))

    def _apply_pending_gauge(self):
        """Tracker thread: fold the published correction into the device
        pose (T ∘ D) and ``last_pose``, re-upload the corrected local map,
        and remember the delta so that frames dispatched before it retire in
        the new gauge. The velocity T_cur ∘ T_prev^-1 is invariant under a
        right composition."""
        with tracing.locked(self._map_lock):
            if self._pending_gauge is None:
                return
            dR, dt = self._pending_gauge
            self._pending_gauge = None
            self._corr_deltas.append((dR, dt))
            self._corr_epoch += 1
            R = self._R.cpu().numpy()
            t = self._t.cpu().numpy()
            self._R = torch.as_tensor(R @ dR, device=self.device)
            self._t = torch.as_tensor(R @ dt + t, device=self.device)
            if self.last_pose is not None:
                Rl, tl = self.last_pose
                self.last_pose = (Rl @ dR, Rl @ dt + tl)
            if self.last_pt_ids is not None and self._lm_args is not None:
                self._refresh_local_map(self.last_pt_ids, self.last_ln_ids, rebind=False)

    def flush(self):
        """Drain all in-flight frames (call before reading the trajectory)."""
        while self._queue:
            pending = self._queue.pop(0)
            if self._finish(pending):
                self.n_lost_frames = 0
            else:
                self._queue.clear()
                self.state = LOST
                self.n_lost_frames += 1

    def dispatch_args(self):
        """The fused step's tensor arguments for this tracker's next frame
        (minus the images); the batched frontend stacks them across
        trackers."""
        return (self._prev_fd, self._prev_slot_pt, self._prev_slot_ln,
                self._pt_remap, self._ln_remap,
                self._R, self._t, self._R_vel, self._t_vel, self._has_vel,
                *self._lm_args)

    def _dispatch(self, gray, depth, out: FusedOut | None = None) -> FusedOut:
        """Run the fused step (unless ``out`` holds it, computed by a
        batched step) and optimistically advance device state."""
        if out is None:
            out = fused_track_step(self.cfg, gray, depth, *self.dispatch_args(),
                                   stereo=self.sensor == "stereo")
        self._pt_remap = self._id_pt
        self._ln_remap = self._id_ln
        self._pt_remap_np = None
        self._ln_remap_np = None
        self._prev_fd = out.fd
        self._prev_slot_pt = out.feat_slot_pt
        self._prev_slot_ln = out.feat_slot_ln
        self._R = out.R
        self._t = out.t
        self._R_vel = out.R_vel
        self._t_vel = out.t_vel
        self._has_vel = True
        return out

    def _quantize_inputs(self, gray, depth):
        """Reduce the inputs as the JAX package's tracker does — results
        depend on it: ``gray_wire_bits`` gray (top bits) and HALF-RES uint16
        depth (depth_map_factor units, 2x2 min-of-nonzero pool; depth is only
        sampled at feature coordinates). A stereo tracker's second input is
        the right image, reduced as the left one."""
        gray = np.asarray(gray)
        depth = np.asarray(depth)
        if gray.dtype != np.uint8:
            gray = np.clip(gray, 0, 255).astype(np.uint8)
        gbits = self.cfg.tracking.gray_wire_bits
        if gbits < 8:
            gray = gray >> (8 - gbits)
        if self.sensor == "stereo":
            if depth.dtype != np.uint8:
                depth = np.clip(depth, 0, 255).astype(np.uint8)
            if gbits < 8:
                depth = depth >> (8 - gbits)
            return np.ascontiguousarray(gray), np.ascontiguousarray(depth)
        h, w = depth.shape
        if depth.dtype != np.uint16:
            f = self.cfg.tracking.depth_map_factor
            depth = np.clip(depth * f, 0, 65535).astype(np.uint16)
        if (h, w) == (self.cfg.camera.height, self.cfg.camera.width) \
                and h % 2 == 0 and w % 2 == 0:
            blocks = depth.reshape(h // 2, 2, w // 2, 2)
            # min over nonzero values; 0 (no depth) only if all 4 are 0:
            # uint16 wraparound maps 0 -> 65535 (loses every min), +1 back
            depth = blocks - np.uint16(1)
            depth = np.minimum(depth[:, 0], depth[:, 1])
            depth = np.minimum(depth[..., 0], depth[..., 1])
            depth += np.uint16(1)
        return np.ascontiguousarray(gray), np.ascontiguousarray(depth)

    def _try_relocalize(self, timestamp: float) -> bool:
        """Relocalization against the keyframe database (Tracking.cc:2049);
        without a vocabulary and database there is nothing to query."""
        out = relocalization.try_relocalize(self, self._prev_fd)
        if out is None:
            return False
        R, t, cur_pt_ids = out
        # motion-prior gate on SHORT-lost relocalization: right after a
        # transient failure the camera is within motion-model reach of the
        # last confident pose, and a relocalization that lands far away has
        # latched onto a drifted sector of the map: reject it and stay LOST
        # (the reference accepts any relocalized pose). The budget scales
        # with the measured per-frame speed (a fast camera legitimately
        # travels several fixed budgets per lost frame); no gate without a
        # speed estimate (right after init) or in localization-only mode
        # (the map is frozen; a kidnapped localizer must reacquire at once)
        if (self.last_pose is not None and self.n_lost_frames < 10
                and self._speed_est is not None and not self.only_tracking):
            Rl, tl = self.last_pose
            jump = float(np.linalg.norm(-(R.T @ t) + (Rl.T @ tl)))
            if jump > 0.06 + 3.0 * self._speed_est * (self.n_lost_frames + 1):
                return False
        # the relocalized pose is in the map's current gauge: drop a
        # correction published for the abandoned pre-LOST state
        self._pending_gauge = None
        tracing.count("reloc.won")
        if self.tracer.enabled:
            self.tracer.emit("reloc", frame=int(self.frame_id), ts=timestamp,
                             n_lost=int(self.n_lost_frames))
        self.state = OK
        self.vo_mode = False
        self.n_lost_frames = 0
        self._adopt_pose(R, t, cur_pt_ids)
        self._record_pose(timestamp, R, t)  # after the refresh: ref_kf is current
        return True

    def _try_reacquire_map(self) -> bool:
        """Relocalize WHILE tracking on visual odometry (the mbVO retry,
        Tracking.cc:393-445): on success the local map is rebound at the
        relocalized pose, which replaces the VO estimate. No trajectory
        entry: the current frame's retirement records the pose."""
        if self._prev_fd is None:
            return False
        out = relocalization.try_relocalize(self, self._prev_fd)
        if out is None:
            return False
        R, t, cur_pt_ids = out
        # consistency gate: VO still HAS a pose (drift-scale error), so a
        # relocalization that disagrees wildly is perceptual aliasing
        # (similar-looking distinct views), not recovery
        R_vo = self._R.cpu().numpy()
        t_vo = self._t.cpu().numpy()
        dc = np.linalg.norm((-R.T @ t) - (-R_vo.T @ t_vo))
        dang = np.arccos(np.clip((np.trace(R @ R_vo.T) - 1) / 2, -1, 1))
        if dc > 0.5 or dang > np.deg2rad(30.0):
            return False
        # frames in flight were dispatched on the VO pose and retire at VO
        # quality; the next dispatch is map-anchored
        self._adopt_pose(R, t, cur_pt_ids)
        self.vo_mode = False
        return True

    def _adopt_pose(self, R, t, cur_pt_ids):
        """Take a relocalized pose and its point bindings as the tracker's
        state and rebind the local map around them."""
        self.last_pose = (R, t)
        self.last_pt_ids = cur_pt_ids
        self.last_ln_ids = np.full(self.cfg.lines.max_lines, -1, np.int32)
        self._R = torch.as_tensor(R, device=self.device)
        self._t = torch.as_tensor(t, device=self.device)
        self._has_vel = False
        with self._map_lock:
            self._refresh_local_map(cur_pt_ids, self.last_ln_ids)

    def reset(self):
        """Full system reset (Tracking::Reset, Tracking.cc:2271-2317)."""
        self.map.reset()
        if self.kfdb is not None:
            self.kfdb.clear()
        if self.local_mapper is not None:
            self.local_mapper.recent_points.clear()
            self.local_mapper.recent_lines.clear()
        self.state = NOT_INITIALIZED
        self.last_kf_id = -1
        self.last_kf = -1
        self.ref_kf = -1
        self.n_lost_frames = 0
        self._speed_est = None
        self._has_vel = False
        self._lm_args = None
        self._pending_gauge = None
        self._corr_deltas = []
        self._corr_epoch = 0
        self.vo_mode = False

    def _record_pose(self, timestamp: float, R: np.ndarray, t: np.ndarray,
                     ref: int | None = None):
        """Append a frame pose, as tracked (absolute) and relative to the
        reference keyframe (healable)."""
        self.trajectory.append((timestamp, R.copy(), t.copy()))
        if ref is None:
            ref = self.ref_kf
        if ref >= 0:
            # T_cr = T_cw ∘ T_wr with T_rw = the reference keyframe's pose now
            Rr, tr = self.map.kf_R[ref], self.map.kf_t[ref]
            Rcr = R @ Rr.T
            tcr = t - Rcr @ tr
        else:
            Rcr, tcr = R.copy(), t.copy()
        self.traj_refs.append((int(ref), Rcr.astype(np.float32), tcr.astype(np.float32)))

    def healed_trajectory(self) -> list[tuple[float, np.ndarray, np.ndarray]]:
        """(timestamp, R, t) per frame, each pose re-composed against the
        CURRENT pose of its reference keyframe (SaveTrajectoryTUM,
        System.cc:350-396). Culled reference keyframes chain through their
        frozen cull-time relative poses to a surviving ancestor."""
        m = self.map
        out = []
        for (ts, R_abs, t_abs), (ref, Rcr, tcr) in zip(self.trajectory, self.traj_refs):
            if ref < 0 or ref >= m.kf_R.shape[0]:
                out.append((ts, R_abs, t_abs))
                continue
            kf = ref
            Rc, tc = Rcr, tcr
            # walk the cull chain: T_cp = T_cr ∘ T_rp (KF0 is never culled)
            while kf > 0 and not m.kf_valid[kf]:
                tc = Rc @ m.kf_cull_tcp[kf] + tc
                Rc = Rc @ m.kf_cull_Rcp[kf]
                kf = int(m.kf_cull_parent[kf])
            Rr, tr = m.kf_R[kf], m.kf_t[kf]
            out.append((ts, (Rc @ Rr).astype(np.float32), (Rc @ tr + tc).astype(np.float32)))
        return out

    # ------------------------------------------------------ initialization
    def _stereo_initialization(self, fd: FrameData, timestamp: float) -> bool:
        """Tracking::StereoInitialization (Tracking.cc:608-727)."""
        host = HostFrame(fd)
        n_depth = int(((host.kp_depth > 0) & host.kp_valid).sum())
        if n_depth < 300:
            return False
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        kf = self.map.add_keyframe(host, R, t, self.frame_id, timestamp, fd_dev=fd)
        pt_ids = self._create_landmarks_from_depth(
            kf, host, R, t, np.full(host.kp_valid.shape, -1, np.int32),
            close_only=False,
        )
        ln_ids = self._create_lines_from_depth(
            kf, host, R, t, np.full(host.ln_valid.shape, -1, np.int32))
        feats = np.nonzero(pt_ids >= 0)[0]
        self.map.scatter_point_descs_from(fd.kp_desc, feats, pt_ids[feats])
        lfeats = np.nonzero(ln_ids >= 0)[0]
        self.map.scatter_line_descs_from(fd.ln_desc, lfeats, ln_ids[lfeats])
        self.last_kf_id = self.frame_id
        self.last_kf = kf
        self.ref_kf = kf
        self.last_pose = (R, t)
        self.last_pt_ids = pt_ids
        self.last_ln_ids = ln_ids
        self._record_pose(timestamp, R, t, ref=kf)
        if self.local_mapper is not None:
            self.local_mapper.on_new_landmarks(kf, pt_ids, ln_ids)
            self.local_mapper.process_keyframe(kf)
        self._register_bow(kf, fd)
        # device state
        self._prev_fd = fd
        self._R = torch.as_tensor(R, device=self.device)
        self._t = torch.as_tensor(t, device=self.device)
        self._has_vel = False
        self._refresh_local_map(pt_ids, ln_ids)
        return True

    def _monocular_initialization(self, fd: FrameData, timestamp: float) -> bool:
        """MonocularInitialization + CreateInitialMapMonocular
        (Tracking.cc:729-903): hold a reference frame, match wide, RANSAC H
        and F, pick by the score ratio, reconstruct, and build the
        two-keyframe map scaled to median depth 1. The RANSAC draws come
        from a generator seeded with the frame id."""
        host = HostFrame(fd)
        if int(host.kp_valid.sum()) <= 100:
            self._mono_ref = None
            return False
        if self._mono_ref is None:
            self._mono_ref = (fd, host, timestamp)
            return False
        rfd, rhost, rts = self._mono_ref
        idx_d, ok_d = mono_init_match(self.cfg, rfd.kp_xy_un, rfd.kp_desc, rfd.kp_valid,
                                      fd.kp_xy_un, fd.kp_desc, fd.kp_valid)
        idx, ok = _to_host([idx_d, ok_d])
        if int(ok.sum()) < 100:  # Tracking.cc:774-780: drop the reference frame
            self._mono_ref = (fd, host, timestamp)
            return False
        uv1 = rfd.kp_xy_un
        uv2 = fd.kp_xy_un[idx_d.long().clamp(0, fd.kp_xy_un.shape[0] - 1)]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.frame_id)
        H, sh, F, sf, okh, okf = mono_init_ops.find_models(uv1, uv2, ok_d, generator=gen)
        sh_f, sf_f = float(sh), float(sf)
        K = torch.as_tensor(self.cfg.camera.K, device=self.device)
        if sh_f / max(sh_f + sf_f, 1e-9) > 0.40:  # Initializer.cc:129-136
            rec = mono_init_ops.reconstruct_h(H, K, uv1, uv2, okh)
        else:
            rec = mono_init_ops.reconstruct_f(F, K, uv1, uv2, okf)
        R, t, pw, good, clear = _to_host(list(rec))
        self.mono_init_stats = dict(frame=self.frame_id, score_h=sh_f, score_f=sf_f,
                                    clear=bool(clear))
        if not bool(clear):
            return False
        good = good & ok
        if good.sum() < 80:
            return False
        # scale: median depth -> 1 (CreateInitialMapMonocular :860-880)
        med = float(np.median(pw[good][:, 2]))
        if med <= 0:
            return False
        R = np.array(R)
        t = (t / med).astype(np.float32)
        pw = (pw / med).astype(np.float32)

        m = self.map
        cfg = self.cfg
        I = np.eye(3, dtype=np.float32)  # noqa: E741
        z3 = np.zeros(3, np.float32)
        with self._map_lock:
            kf0 = m.add_keyframe(rhost, I, z3, self.frame_id - 1, rts, fd_dev=rfd)
            kf1 = m.add_keyframe(host, R, t, self.frame_id, timestamp, fd_dev=fd)
            cur_pt_ids = np.full(cfg.orb.max_keypoints, -1, np.int32)
            new_feats, new_pids = [], []
            c1 = np.zeros(3)
            for f in np.nonzero(good)[0]:
                p = pw[f]
                dist = float(np.linalg.norm(p - c1))
                max_d = dist * cfg.orb.scale_factor ** int(rhost.kp_octave[f])
                min_d = max_d / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)
                normal = (p - c1) / max(dist, 1e-6)
                pid = m.add_point(p, None, normal, min_d, max_d, kf0)
                f2 = int(idx[f])
                m.add_point_obs(pid, kf0, int(f))
                m.add_point_obs(pid, kf1, f2)
                cur_pt_ids[f2] = pid
                new_feats.append(int(f))
                new_pids.append(pid)
            new_pids = np.array(new_pids, np.int32)
            m.scatter_point_descs_from(rfd.kp_desc, np.array(new_feats, np.int32), new_pids)
            self.last_kf_id = self.frame_id
            self.last_kf = kf1
            self.ref_kf = kf1
            self.last_pose = (R, t)
            self.last_pt_ids = cur_pt_ids
            self.last_ln_ids = np.full(cfg.lines.max_lines, -1, np.int32)
            self._record_pose(rts, I, z3, ref=kf0)
            self._record_pose(timestamp, R, t, ref=kf1)
            if self.local_mapper is not None:
                self.local_mapper.on_new_landmarks(kf1, new_pids, np.zeros(0, np.int32))
                self.local_mapper.process_keyframe(kf1)
            self._register_bow(kf0, rfd)
            self._register_bow(kf1, fd)
            self._mono_ref = None
            # device state
            self._prev_fd = fd
            self._R = torch.as_tensor(R, device=self.device)
            self._t = torch.as_tensor(t, device=self.device)
            self._has_vel = False
            self._refresh_local_map(cur_pt_ids, self.last_ln_ids)
        return True

    # ------------------------------------------------------------- tracking
    def _finish(self, pending: dict) -> bool:
        """Retire a dispatched frame (bookkeeping + KF decision), from ONE
        host copy of the fields it needs."""
        with tracing.span("track.finish", frame=pending["frame_id"]):
            cfg = self.cfg
            out: FusedOut = pending["out"]
            timestamp = pending["timestamp"]
            frame_id = pending["frame_id"]
            lp_ids = pending["lp_ids"]
            ll_ids = pending["ll_ids"]
            fd = out.fd
            host = pending.get("host")
            with tracing.span("sync.retire"):
                fields = host() if host is not None else _to_host(_record_tensors(out))
            (stats, R, t, lm_feat, lm_inlier, lm_vis, lml_feat, lml_inlier,
             kp_xy_un, kp_octave, kp_depth, kp_valid,
             ln_ep_un, ln_desc, ln_depth, ln_valid) = fields
            R = np.array(R)
            t = np.array(t)
            # frames dispatched before a gauge correction retire in the new
            # gauge: right-compose every delta published since their dispatch
            for dR, dt in self._corr_deltas[pending["epoch"]:]:
                R, t = R @ dR, R @ dt + t
            n_mm, n_mi, n_li, tc, cc, n_rs = (int(v) for v in stats)
            self.debug = {
                "motion_matches": n_mm, "motion_inliers": n_mi,
                "local_inliers": n_li, "local_points": len(lp_ids),
                "rescue_inliers": n_rs,
            }
            n_in = n_li
            if not (n_mi >= 10 and n_in >= cfg.tracking.min_inliers_local_map):
                # mbVO (Tracking.cc:344-445, :512-520): in localization-only mode
                # the motion stage matches TEMPORAL points (backprojected from
                # the previous frame's depth) for every feature the map did not
                # bind, so a healthy motion-inlier count means visual odometry
                # carries the pose although map localization starved: keep
                # tracking, flag VO mode, retry relocalization until reacquired
                if not (self.only_tracking and n_mi >= 20):
                    return False
                self.vo_mode = True
            elif self.vo_mode and n_in >= 2 * cfg.tracking.min_inliers_local_map:
                self.vo_mode = False  # map reacquired by matching alone

            # host bookkeeping (ids resolved against the DISPATCH-time snapshot),
            # under the map lock: a mapper thread edits the same arrays
            with tracing.locked(self._map_lock):
                k = len(lp_ids)
                lm_inlier = lm_inlier.copy()
                lm_inlier[k:] = False
                vis = lm_vis.copy()
                vis[k:] = False
                self.map.pt_visible[lp_ids[vis[:k]]] += 1
                self.map.pt_found[lp_ids[lm_inlier[:k]]] += 1
                cur_pt_ids = np.full(cfg.orb.max_keypoints, -1, np.int32)
                sel = np.nonzero(lm_inlier[:k])[0]
                cur_pt_ids[lm_feat[sel]] = lp_ids[sel]
                kl = len(ll_ids)
                lml_inlier = lml_inlier.copy()
                lml_inlier[kl:] = False
                cur_ln_ids = np.full(cfg.lines.max_lines, -1, np.int32)
                lsel = np.nonzero(lml_inlier[:kl])[0]
                cur_ln_ids[lml_feat[lsel]] = ll_ids[lsel]
                self.map.ln_visible[ll_ids[lsel]] += 1
                self.map.ln_found[ll_ids[lsel]] += 1

                if self.last_pose is not None:
                    Rl, tl = self.last_pose
                    disp = float(np.linalg.norm(-(R.T @ t) + (Rl.T @ tl)))
                    # decayed max: a momentary stop must not shrink the
                    # relocalization budget below the scale of recent motion;
                    # the decay bleeds off one-frame spikes, the clamp keeps a
                    # pathological jump from disabling the gate for good
                    self._speed_est = min(max(disp, 0.8 * (self._speed_est or 0.0)), 2.0)
                self.last_pose = (R, t)
                self.last_pt_ids = cur_pt_ids
                self.last_ln_ids = cur_ln_ids
                self._record_pose(timestamp, R, t)

                need = self._need_new_keyframe(tc, cc, n_in, frame_id=frame_id)
                if self.tracer.enabled:
                    self.tracer.emit(
                        "frame", frame=int(frame_id), ts=timestamp, state=self.state,
                        motion_inliers=n_mi, rescue_inliers=n_rs, local_inliers=n_in,
                        tracked_close=tc, points=len(lp_ids), lines=len(ll_ids),
                        kf=need, n_kf=self.map.n_kf)
            if need:
                host = _host_frame(cfg, kp_xy_un, kp_octave, kp_depth, kp_valid,
                                   ln_ep_un, ln_desc, ln_depth, ln_valid)
                with tracing.locked(self._map_lock):
                    self._create_new_keyframe(fd, R, t, cur_pt_ids, cur_ln_ids, timestamp,
                                              frame_id=frame_id, host=host)
                    # the spawning frame references its OWN keyframe, at identity
                    # by construction (Tracking.cc:1664): not recomputed from
                    # kf_R, which a BA inside process_keyframe may have moved
                    self.traj_refs[-1] = (int(self.last_kf), np.eye(3, dtype=np.float32),
                                          np.zeros(3, np.float32))
                self._refresh_inl = n_in
            elif (frame_id - self._refresh_frame >= self.REFRESH_MAX_FRAMES
                  or n_in < 0.5 * self._refresh_inl):
                # the reference re-harvests the local map EVERY frame
                # (UpdateLocalKeyFrames, Tracking.cc:1867-2035); a bounded
                # cadence + inlier-decay trigger is the pipelined equivalent
                with tracing.locked(self._map_lock):
                    self._refresh_local_map(cur_pt_ids, cur_ln_ids, rebind=False)
                self._refresh_inl = n_in
            return True

    # --------------------------------------------------- local map handling
    def _refresh_local_map(self, cur_pt_ids, cur_ln_ids, rebind: bool = True):
        """Harvest the covisibility-local map and upload device tensors
        (UpdateLocalKeyFrames/Points/Lines, Tracking.cc:1867-2035).

        ``rebind=True`` (init) rewrites the device feature→slot tables from
        ``cur_*_ids``. ``rebind=False`` (keyframe events) instead uploads
        old-slot→new-slot remap vectors: the in-flight frame was dispatched
        against the OLD slot space and its slot tables are reconciled inside
        the next fused step."""
        with tracing.span("track.local_map"):
            old_lp = self._lp_ids
            old_ll = self._ll_ids
            self._refresh_frame = self.frame_id
            lkfs = self._local_keyframes(cur_pt_ids)
            lp_ids, ll_ids = self._local_landmarks(lkfs)
            self._lp_ids = lp_ids
            self._ll_ids = ll_ids
            m = self.map
            dev = self.device
            LM, LL = self.LM_CAP, self.LL_CAP
            k = len(lp_ids)
            p3d = np.zeros((LM, 3), np.float32)
            normal = np.zeros((LM, 3), np.float32)
            mind = np.zeros(LM, np.float32)
            maxd = np.zeros(LM, np.float32)
            valid = np.zeros(LM, bool)
            pid_pad = np.zeros(LM, np.int64)
            p3d[:k] = m.pt_pos[lp_ids]
            normal[:k] = m.pt_normal[lp_ids]
            mind[:k] = m.pt_min_dist[lp_ids]
            maxd[:k] = m.pt_max_dist[lp_ids]
            valid[:k] = True
            pid_pad[:k] = lp_ids
            kl = len(ll_ids)
            lep = np.zeros((LL, 2, 3), np.float32)
            lvalid = np.zeros(LL, bool)
            lid_pad = np.zeros(LL, np.int64)
            lep[:kl] = m.ln_ep[ll_ids]
            lvalid[:kl] = True
            lid_pad[:kl] = ll_ids
            # descriptors are gathered from the device arenas by id — the
            # descriptor bytes never leave the device
            desc = m.point_desc_arena()[torch.as_tensor(pid_pad, device=dev)]
            ldesc = m.line_desc_arena()[torch.as_tensor(lid_pad, device=dev)]
            up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
            self._lm_args = (up(p3d), desc, up(normal), up(mind), up(maxd), up(valid),
                             up(lep), ldesc, up(lvalid))
            # id -> slot lookup tables
            slot_lut_pt = np.full(m.pt_pos.shape[0], -1, np.int32)
            slot_lut_pt[lp_ids] = np.arange(len(lp_ids), dtype=np.int32)
            slot_lut_ln = np.full(m.ln_ep.shape[0], -1, np.int32)
            slot_lut_ln[ll_ids] = np.arange(len(ll_ids), dtype=np.int32)
            if rebind:
                fs = np.where(cur_pt_ids >= 0, slot_lut_pt[np.clip(cur_pt_ids, 0, None)], -1)
                fsl = np.where(cur_ln_ids >= 0, slot_lut_ln[np.clip(cur_ln_ids, 0, None)], -1)
                self._prev_slot_pt = up(fs.astype(np.int32))
                self._prev_slot_ln = up(fsl.astype(np.int32))
                self._pt_remap = self._id_pt
                self._ln_remap = self._id_ln
                self._pt_remap_np = None
                self._ln_remap_np = None
            else:
                # old-slot -> new-slot remaps for the in-flight frames
                rm = np.full(self.LM_CAP, -1, np.int32)
                if len(old_lp):
                    rm[: len(old_lp)] = slot_lut_pt[old_lp]
                rml = np.full(self.LL_CAP, -1, np.int32)
                if len(old_ll):
                    rml[: len(old_ll)] = slot_lut_ln[old_ll]
                # compose with a not-yet-consumed remap
                if self._pt_remap_np is not None:
                    prev = self._pt_remap_np
                    rm = np.where(prev >= 0, rm[np.clip(prev, 0, None)], -1)
                if self._ln_remap_np is not None:
                    prev = self._ln_remap_np
                    rml = np.where(prev >= 0, rml[np.clip(prev, 0, None)], -1)
                self._pt_remap_np = rm
                self._ln_remap_np = rml
                self._pt_remap = up(rm)
                self._ln_remap = up(rml)

    def _local_keyframes(self, cur_pt_ids: np.ndarray) -> list[int]:
        """KFs observing current points + covisible neighbors (cap 80)."""
        m = self.map
        cur = cur_pt_ids[cur_pt_ids >= 0]
        counts: dict[int, int] = {}
        if len(cur) and m.n_kf:
            lut = np.zeros(m.pt_pos.shape[0], bool)
            lut[cur] = True
            sub = m.kf_pt_idx[: m.n_kf]
            mask = (sub >= 0) & lut[np.clip(sub, 0, None)]
            carr = mask.sum(1)
            nz = np.nonzero(carr)[0]
            counts = {int(o): int(carr[o]) for o in nz}
        if not counts:
            return [self.ref_kf] if self.ref_kf >= 0 else []
        k1 = sorted(counts, key=counts.get, reverse=True)
        self.ref_kf = k1[0]
        out = list(k1)
        seen = set(out)
        depth = {kf: 0 for kf in out}
        # depth-2 BFS over covisibility neighbors + spanning-tree
        # parent/children (UpdateLocalKeyFrames, Tracking.cc:1966-2025)
        i = 0
        while i < len(out) and len(out) < self.cfg.tracking.local_map_kf_cap:
            kf = out[i]
            i += 1
            if depth[kf] >= 2:
                continue
            neigh = list(m.covisible_keyframes(kf, 10))
            p = int(m.kf_parent[kf])
            if p >= 0 and m.kf_valid[p]:
                neigh.append(p)
            neigh.extend(c for c in m.kf_children[kf] if m.kf_valid[c])
            for nkf in neigh:
                if nkf not in seen:
                    out.append(nkf)
                    seen.add(nkf)
                    depth[nkf] = depth[kf] + 1
        return out[: self.cfg.tracking.local_map_kf_cap]

    def _local_landmarks(self, lkfs: list[int]):
        if not lkfs:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        pts = np.unique(self.map.kf_pt_idx[lkfs])
        pts = pts[(pts >= 0) & self.map.pt_valid[np.clip(pts, 0, None)]]
        lns = np.unique(self.map.kf_ln_idx[lkfs])
        lns = lns[(lns >= 0) & self.map.ln_valid[np.clip(lns, 0, None)]]
        return (pts[: self.LM_CAP].astype(np.int32),
                lns[: self.LL_CAP].astype(np.int32))

    # -------------------------------------------------------- keyframe logic
    def _need_new_keyframe(self, tracked_close, creatable_close, n_inliers,
                           frame_id: int | None = None):
        """NeedNewKeyFrame (Tracking.cc:1423-1557); never in
        localization-only mode. Monocular: no close points to mint, so no
        need_close and no c1c, and the 0.9 reference ratio (:1504-1509)."""
        if self.only_tracking:
            return False
        if frame_id is None:
            frame_id = self.frame_id
        cfg = self.cfg.tracking
        mono = self.sensor == "mono"
        need_close = (not mono) and (tracked_close < 100) and (creatable_close > 70)
        min_obs = 2 if self.map.n_kf <= 2 else 3
        ref_tracked = 1
        ref = self.ref_kf
        if ref >= 0 and not self.map.kf_valid[ref]:
            ref = max((q for q in range(self.map.n_kf) if self.map.kf_valid[q]),
                      default=-1)
            self.ref_kf = ref
        if ref >= 0:
            pids = self.map.kf_pt_idx[ref]
            pids = pids[pids >= 0]
            cnt = sum(1 for p in pids if len(self.map.pt_obs[p]) >= min_obs)
            ref_tracked = max(cnt if cnt > 0 else len(pids), 1)
        c1a = frame_id >= self.last_kf_id + cfg.max_frames_between_kf
        c1b = frame_id >= self.last_kf_id + max(cfg.min_frames_between_kf, 1)
        c1c = (not mono) and ((n_inliers < ref_tracked * 0.25) or need_close)
        th_ref = 0.9 if mono else 0.75
        c2 = ((n_inliers < ref_tracked * th_ref) or need_close) and n_inliers > 15
        return bool((c1a or c1b or c1c) and c2)

    def _create_new_keyframe(self, fd: FrameData, R, t, cur_pt_ids,
                             cur_ln_ids, ts, frame_id: int | None = None,
                             host: HostFrame | None = None):
        """CreateNewKeyFrame (Tracking.cc:1567-1744)."""
        with tracing.span("track.keyframe"):
            if frame_id is None:
                frame_id = self.frame_id
            if host is None:
                host = HostFrame(fd)
            kf = self.map.add_keyframe(host, R, t, frame_id, ts, fd_dev=fd)
            for feat, pid in enumerate(cur_pt_ids):
                if pid >= 0 and self.map.pt_valid[pid]:
                    self.map.add_point_obs(int(pid), kf, feat)
            for feat, lid in enumerate(cur_ln_ids):
                if lid >= 0 and self.map.ln_valid[lid]:
                    self.map.add_line_obs(int(lid), kf, feat)
            new_pt = self._create_landmarks_from_depth(kf, host, R, t, cur_pt_ids,
                                                       close_only=True)
            cur_pt_ids = cur_pt_ids.copy()
            cur_pt_ids[new_pt >= 0] = new_pt[new_pt >= 0]
            new_ln = self._create_lines_from_depth(kf, host, R, t, cur_ln_ids)
            cur_ln_ids = cur_ln_ids.copy()
            cur_ln_ids[new_ln >= 0] = new_ln[new_ln >= 0]
            # new landmarks take their descriptors straight from the keyframe's
            # device FrameData
            feats = np.nonzero(new_pt >= 0)[0]
            self.map.scatter_point_descs_from(fd.kp_desc, feats, new_pt[feats])
            lfeats = np.nonzero(new_ln >= 0)[0]
            self.map.scatter_line_descs_from(fd.ln_desc, lfeats, new_ln[lfeats])
            self.last_kf_id = frame_id
            self.last_kf = kf
            self.ref_kf = kf
            if self.local_mapper is not None:
                self.local_mapper.on_new_landmarks(kf, new_pt, new_ln)
                self.local_mapper.process_keyframe(kf)
            self._register_bow(kf, fd)
            if self.loop_closer is not None:
                self.loop_closer.process_keyframe(kf)
            self.last_pt_ids = cur_pt_ids
            self.last_ln_ids = cur_ln_ids
            self._refresh_local_map(cur_pt_ids, cur_ln_ids, rebind=False)

    def _register_bow(self, kf: int, fd: FrameData):
        """A new keyframe's bag of words into the database; the database
        takes the nonzero (word, weight) pairs."""
        if self.kfdb is not None and self.voc is not None:
            with tracing.span("track.bow"):
                _, bow = self.voc.transform(fd.kp_desc, fd.kp_valid)
                self.kfdb.add(kf, sparse_bow(bow))

    def _create_landmarks_from_depth(self, kf, host, R, t, cur_pt_ids,
                                     close_only: bool) -> np.ndarray:
        """New map points from depth, closest-first; close ones always, far
        ones only up to the 100-point floor (Tracking.cc:1630-1700)."""
        cfg = self.cfg
        out = np.full(host.kp_valid.shape, -1, np.int32)
        cand = host.kp_valid & (host.kp_depth > 0) & (cur_pt_ids < 0)
        idxs = np.nonzero(cand)[0]
        if len(idxs) == 0:
            return out
        order = idxs[np.argsort(host.kp_depth[idxs])]
        n_existing = int((cur_pt_ids >= 0).sum())
        Rwc = R.T
        c = -Rwc @ t
        uv = host.kp_xy_un[order]
        d = host.kp_depth[order]
        pc = _backproject_np(cfg.camera, uv, d)
        pw = pc @ Rwc.T + c
        dist = np.linalg.norm(pw - c, axis=1)
        level = host.kp_octave[order]
        max_d = dist * cfg.orb.scale_factor**level
        min_d = max_d / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)
        normal = (pw - c) / np.maximum(dist[:, None], 1e-6)
        created = 0
        for j, feat in enumerate(order):
            if close_only and d[j] > cfg.tracking.th_depth and (
                    n_existing + created >= 100):
                break
            pid = self.map.add_point(pw[j], None, normal[j], min_d[j], max_d[j], kf)
            self.map.add_point_obs(pid, kf, int(feat))
            out[feat] = pid
            created += 1
        return out

    def _create_lines_from_depth(self, kf, host, R, t, cur_ln_ids) -> np.ndarray:
        """New map lines from endpoint depths (Tracking.cc:1700-1735)."""
        cfg = self.cfg
        out = np.full(host.ln_valid.shape, -1, np.int32)
        cand = (
            host.ln_valid
            & (host.ln_depth > 0).all(1)
            & (host.ln_depth < cfg.tracking.th_depth * 2).all(1)
            & (cur_ln_ids < 0)
        )
        Rwc = R.T
        c = -Rwc @ t
        feats = np.nonzero(cand)[0]
        if len(feats):
            pc = _backproject_np(cfg.camera, host.ln_ep_un[feats].reshape(-1, 2),
                                 host.ln_depth[feats].reshape(-1))
            ep_w = (pc @ Rwc.T + c).reshape(-1, 2, 3).astype(np.float32)
            for i, feat in enumerate(feats):
                lid = self.map.add_line(ep_w[i], None, kf)
                self.map.add_line_obs(lid, kf, int(feat))
                out[feat] = lid
        return out


def _host_frame(cfg, kp_xy_un, kp_octave, kp_depth, kp_valid,
                ln_ep_un, ln_desc, ln_depth, ln_valid) -> HostFrame:
    """Keyframe snapshot from the per-frame host record. Derived fields are
    recomputed (kp_ur from xy_un+depth, the formula build_frame uses);
    fields with no host consumer (descriptors, responses, angles, raw
    coords, ln_coeff) are zero-filled — the device holds the real values."""
    cam = cfg.camera
    n = kp_valid.shape[0]
    nl = ln_valid.shape[0]
    has_d = kp_depth > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        ur = np.where(has_d, kp_xy_un[:, 0] - cam.bf / np.where(
            has_d, kp_depth, 1.0), -1.0).astype(np.float32)
    z = np.zeros
    return HostFrame(FrameData(
        kp_xy=kp_xy_un, kp_xy_un=kp_xy_un, kp_resp=z(n, np.float32),
        kp_octave=kp_octave.astype(np.int32), kp_angle=z(n, np.float32),
        kp_desc=z((n, 32), np.uint8), kp_depth=kp_depth, kp_ur=ur,
        kp_valid=kp_valid,
        ln_ep=ln_ep_un, ln_ep_un=ln_ep_un, ln_angle=z(nl, np.float32),
        ln_length=np.linalg.norm(ln_ep_un[:, 1] - ln_ep_un[:, 0], axis=-1).astype(np.float32),
        ln_coeff=z((nl, 3), np.float32), ln_desc=ln_desc,
        ln_depth=ln_depth, ln_valid=ln_valid,
    ))


def _backproject_np(cam, uv: np.ndarray, depth: np.ndarray) -> np.ndarray:
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    return np.stack([x * depth, y * depth, depth], -1).astype(np.float32)
