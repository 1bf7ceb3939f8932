"""``reloc_match_mismatch_share``, ``reloc_pose_gap_mm``,
``bow_word_mismatch_share`` and ``reloc_candidate_mismatch_share``: the
window's relocalizations held to the plain reference of relocalization
(``reference_reloc.py``).

The harness samples steady frames, and a relocalizing frame never is one,
so this oracle records relocalizations itself, from the moment it is
loaded: while ``try_relocalize`` runs on the tracker's thread, every
candidate try (``reloc_candidate_step``: the frame, the candidate's
descriptors, angles and map points, the RANSAC generator, and what the try
returned), the query's bag of words (``Vocabulary.transform``) and the
keyframe database's answer (``detect_reloc_candidates``) with the database
as it stood: each keyframe's words and weights, which keyframes are valid
and each one's best 10 covisible keyframes, taken under the map lock that
the query holds. Tensors are copied. It keeps the first ``MAX_RELOCS``
relocalizations that tried a candidate (a blacked-out frame finds none) and
hands them over, and forgets them, in ``readings``.

- ``reloc_match_mismatch_share``: of the features that either side matched
  in a recorded try, the share whose candidate feature differs from the
  reference's match on the same inputs. Control: distances summed in int8.
- ``reloc_pose_gap_mm``: the largest distance between the camera centre of
  an accepted try (50 inliers or more) and the reference's from the try's
  own matches: its RANSAC drawn from a generator seeded as the try's was,
  then the pose LM in float64. Control: the reference's LM in bfloat16.
- ``bow_word_mismatch_share``: of the recorded queries' valid descriptors
  and nonzero weights, the share whose word differs from the reference's
  tree walk over the program's vocabulary, or whose weight differs by more
  than 1e-6. Control: distances summed in int8.
- ``reloc_candidate_mismatch_share``: of the recorded database queries, the
  share whose candidate list (keyframes and their order) differs from
  ``reference_reloc.reloc_candidates`` on the same database. Control: the
  query's bag of words from the tree walk with distances summed in int8,
  then shared words counted in int8.
"""

import threading

import numpy as np
import torch

from benchmark import reference_reloc as rr
from benchmark.hooks import Hooks

NUMBERS = ("reloc_match_mismatch_share", "reloc_pose_gap_mm", "bow_word_mismatch_share",
           "reloc_candidate_mismatch_share")
CAPTURES = {}
SCOPE = "plslam_torch.models.relocalization:try_relocalize"
STEP = "plslam_torch.models.relocalization:reloc_candidate_step"
BOW = "plslam_torch.bow.vocabulary:Vocabulary.transform"
QUERY = "plslam_torch.bow.database:KeyFrameDatabase.detect_reloc_candidates"
# relocalizations kept a run: the configuration's correct.max_samples, which
# an oracle is not handed (benchmark/tests/test_bench_slam.py holds the two
# equal)
MAX_RELOCS = 6
WEIGHT_TOL = 1e-6


class _Relocalizations(Hooks):
    """The hooks of one process: the candidate tries, bags of words and
    database queries of each relocalization, tagged with its number."""

    def __init__(self):
        super().__init__()
        self.kept = 0
        self.record("try", STEP, self._inside, main_only=True, copy=True)
        self.record("bow", BOW, self._inside, main_only=True, copy=True)
        self.calls["query"] = []
        self._wrap(QUERY, self._query)
        self._wrap(SCOPE, self._scoped)

    def _query(self, fn):
        def wrapper(db, bow, slam_map, *a, **k):
            inside = self._inside() and threading.get_ident() == self._main
            if inside:
                bows = {kf: tuple(np.array(x) for x in db.get_bow(kf))
                        for kf in range(db.max_kf) if db.has[kf]}
                valid = np.array(slam_map.kf_valid)
                covis = {kf: list(slam_map.covisible_keyframes(kf, 10))
                         for kf in bows if valid[kf]}
            res = fn(db, bow, slam_map, *a, **k)
            if inside:
                query = tuple(np.array(x) for x in bow)
                self.calls["query"].append((self.tag, (query, bows, valid, covis), {}, list(res)))
            return res
        return wrapper

    def _inside(self) -> bool:
        return self.tag is not None

    def _scoped(self, fn):
        def wrapper(*a, **k):
            if self.kept >= MAX_RELOCS or threading.get_ident() != self._main:
                return fn(*a, **k)
            self.tag = self.kept
            try:
                return fn(*a, **k)
            finally:
                self.tag = None
                if any(c[0] == self.kept for c in self.calls["try"]):
                    self.kept += 1
                else:
                    for label in ("bow", "query"):
                        self.calls[label][:] = [c for c in self.calls[label] if c[0] != self.kept]
        return wrapper

    def hand_over(self) -> tuple[list, list, list]:
        out = list(self.calls["try"]), list(self.calls["bow"]), list(self.calls["query"])
        for calls in self.calls.values():
            calls.clear()
        self.kept = 0
        return out


_HOOKS = _Relocalizations()
_handed: tuple[list, list, list] | None = None


def readings(calls, ctx, control):
    global _handed
    if not control or _handed is None:
        _handed = _HOOKS.hand_over()
    tries, bows, queries = _handed
    cfg = ctx.cfg
    dist_dtype = torch.int8 if control else torch.int32
    either = differ = 0
    gap = 0.0
    for _, args, _, res in tries:
        _, fd, kf_desc, kf_angle, kf_has, kf_pt_w = args[:6]
        gen = args[6] if len(args) > 6 else None
        R, t, idx, _, n = res
        want = rr.reloc_match(fd.kp_desc, fd.kp_valid, fd.kp_angle, kf_desc, kf_angle, kf_has,
                              cfg.matcher.nn_ratio_reloc)
        got = (rr.reloc_match(fd.kp_desc, fd.kp_valid, fd.kp_angle, kf_desc, kf_angle, kf_has,
                              cfg.matcher.nn_ratio_reloc, dist_dtype)
               if control else idx.long())
        either += int(((want >= 0) | (got >= 0)).sum())
        differ += int((want != got).sum())
        if int(n) < rr.ACCEPT_INLIERS or gen is None:
            continue
        f = {k: getattr(fd, k) for k in ("kp_xy_un", "kp_ur", "kp_octave", "kp_depth")}
        args_ref = (cfg.camera, cfg.orb.scale_factor, f, idx.long(), kf_pt_w, gen.initial_seed())
        Rr, tr, _ = rr.reloc_pose(*args_ref)
        if control:
            R, t, _ = rr.reloc_pose(*args_ref, dtype=torch.bfloat16)
        gap = max(gap, rr.centre_gap_mm(R, t, Rr, tr))
    n_bow = bad_bow = 0
    control_query = {}
    for tag, args, _, res in bows:
        voc, desc, valid = args[:3]
        words, weights = rr.bow(desc, valid, voc.node_desc, voc.idf)
        if control:
            got_w, got_b = rr.bow(desc, valid, voc.node_desc, voc.idf, dist_dtype, torch.float32)
            ids = torch.nonzero(got_b).squeeze(1)
            control_query[tag] = (ids.cpu().numpy(), got_b[ids].cpu().numpy())
        else:
            got_w, got_b = res[0].long(), res[1]
        n_bow += int(valid.sum())
        bad_bow += int(((words != got_w) & valid).sum())
        nz = (weights != 0) | (got_b != 0)
        n_bow += int(nz.sum())
        bad_bow += int(((weights - got_b.double()).abs() > WEIGHT_TOL)[nz].sum())
    count_dtype = np.int8 if control else np.int64
    bad_query = 0
    for tag, (query, kf_bows, valid, covis), _, got in queries:
        want = rr.reloc_candidates(query, kf_bows, valid, lambda kf, n: covis[kf][:n])
        if control:
            got = rr.reloc_candidates(control_query[tag], kf_bows, valid,
                                      lambda kf, n: covis[kf][:n], count_dtype)
        bad_query += want != got
    return {"reloc_match_mismatch_share": differ / either if either else 0.0,
            "reloc_pose_gap_mm": gap,
            "bow_word_mismatch_share": bad_bow / n_bow if n_bow else 0.0,
            "reloc_candidate_mismatch_share": bad_query / len(queries) if queries else 0.0}
