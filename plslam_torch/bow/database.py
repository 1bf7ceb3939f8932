"""Keyframe database: BoW retrieval for loop closing and relocalization.

The reference's inverted-file ``KeyFrameDatabase`` (KeyFrameDatabase.cc):
a posting list per word (word -> {keyframe: weight}), so scoring a query
costs O(query words x posting lengths) whatever the vocabulary's size.
Host numpy and Python dicts, as in the JAX package's ``bow/database.py``,
which this module copies. The candidate-selection protocol of the
reference:

- DetectLoopCandidates: exclude covisible keyframes, require shared words
  > 0.8 * max shared, accumulate scores over covisibility groups, accept
  groups > 0.75 * best accumulated score (:113-271).
- DetectRelocalizationCandidates: the same without the covisible
  exclusion (:274-413).

Scores are DBoW2 L1 (2 * sum min(q_w, v_w) over shared words for
L1-normalized vectors, ScoringObject.cc). A bow is given dense (a numpy
array of the vocabulary's width) or as the sparse pair (word ids, values)
that ``vocabulary.sparse_bow`` copies off the device; both give the same
database state.
"""

from __future__ import annotations

import numpy as np

from .vocabulary import Vocabulary


def _sparse(bow) -> tuple[np.ndarray, np.ndarray]:
    if isinstance(bow, tuple):
        return np.asarray(bow[0], np.int64), np.asarray(bow[1], np.float32)
    bow = np.asarray(bow)
    ids = np.nonzero(bow)[0]
    return ids, bow[ids].astype(np.float32)


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, max_kf: int = 1024):
        self.voc = voc
        self.max_kf = max_kf
        self.has = np.zeros(max_kf, bool)
        self._ids: list[np.ndarray | None] = [None] * max_kf
        self._vals: list[np.ndarray | None] = [None] * max_kf
        self._inv: dict[int, dict[int, float]] = {}

    # ------------------------------------------------------------- mutation
    def add(self, kf: int, bow):
        """Register a keyframe's bow vector (dense, or sparse (ids, vals))."""
        ids, vals = _sparse(bow)
        if self.has[kf]:
            self.erase(kf)
        self._ids[kf] = ids
        self._vals[kf] = vals
        for w, v in zip(ids.tolist(), vals.tolist()):
            self._inv.setdefault(w, {})[kf] = v
        self.has[kf] = True

    def erase(self, kf: int):
        if self._ids[kf] is not None:
            for w in self._ids[kf].tolist():
                post = self._inv.get(w)
                if post is not None:
                    post.pop(kf, None)
            self._ids[kf] = None
            self._vals[kf] = None
        self.has[kf] = False

    def clear(self):
        self.has[:] = False
        self._ids = [None] * self.max_kf
        self._vals = [None] * self.max_kf
        self._inv.clear()

    def get_bow(self, kf: int):
        """Sparse (ids, vals) of a registered keyframe."""
        return self._ids[kf], self._vals[kf]

    # -------------------------------------------------------------- scoring
    def score_all(self, bow) -> np.ndarray:
        """L1 scores against every registered keyframe (inverted-file
        accumulation: touches only keyframes sharing a word)."""
        ids, vals = _sparse(bow)
        s = np.zeros(self.max_kf, np.float32)
        for w, qv in zip(ids.tolist(), vals.tolist()):
            post = self._inv.get(w)
            if post:
                for kf, v in post.items():
                    s[kf] += 2.0 * min(qv, v)
        s[~self.has] = 0.0
        return s

    def shared_words(self, bow) -> np.ndarray:
        ids, _ = _sparse(bow)
        c = np.zeros(self.max_kf, np.int64)
        for w in ids.tolist():
            post = self._inv.get(w)
            if post:
                for kf in post:
                    c[kf] += 1
        return c * self.has

    # ----------------------------------------------------------- candidates
    @staticmethod
    def _mask_invalid(shared: np.ndarray, slam_map):
        """A culled keyframe cannot anchor a loop or a relocalization (its
        observations are detached); on top of erase-at-cull, since an
        asynchronous mapper can cull between registration and a query."""
        valid = getattr(slam_map, "kf_valid", None)
        if valid is None:  # stub maps without validity tracking
            return
        n = min(len(shared), len(valid))
        shared[:n] *= valid[:n]
        shared[n:] = 0

    @staticmethod
    def _accumulate(cand, scores, slam_map, eligible) -> list[int]:
        """Scores accumulated over each candidate's covisibility group (its
        best 10 neighbours), groups above 0.75 of the best accumulated
        score, each group represented by its best-scoring keyframe."""
        valid = getattr(slam_map, "kf_valid", None)
        acc = []
        for c in cand:
            group = [c] + [g for g in slam_map.covisible_keyframes(int(c), 10)
                           if valid is None or valid[g]]
            g_scores = [scores[g] for g in group if eligible(g)] or [scores[c]]
            best_in_group = group[int(np.argmax([scores[g] for g in group]))]
            acc.append((float(sum(g_scores)), int(best_in_group)))
        th = 0.75 * max(a for a, _ in acc)
        out = []
        seen = set()
        for a, b in acc:
            if a > th and b not in seen:
                out.append(b)
                seen.add(b)
        return out

    def detect_loop_candidates(self, kf: int, bow, min_score: float,
                               covisible: set[int], slam_map) -> list[int]:
        """KeyFrameDatabase::DetectLoopCandidates semantics."""
        shared = self.shared_words(bow)
        shared[kf] = 0
        for c in covisible:
            shared[c] = 0
        self._mask_invalid(shared, slam_map)
        if shared.max() == 0:
            return []
        min_common = 0.8 * shared.max()
        scores = self.score_all(bow)
        cand = np.nonzero((shared > min_common) & (scores >= min_score))[0]
        if len(cand) == 0:
            return []
        return self._accumulate(
            cand, scores, slam_map,
            lambda g: shared[g] > min_common and scores[g] >= min_score)

    def detect_reloc_candidates(self, bow, slam_map) -> list[int]:
        """KeyFrameDatabase::DetectRelocalizationCandidates semantics."""
        shared = self.shared_words(bow)
        self._mask_invalid(shared, slam_map)
        if shared.max() == 0:
            return []
        min_common = 0.8 * shared.max()
        scores = self.score_all(bow)
        cand = np.nonzero(shared > min_common)[0]
        if len(cand) == 0:
            return []
        return self._accumulate(cand, scores, slam_map, lambda g: shared[g] > min_common)
