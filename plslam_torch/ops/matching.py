"""Point-feature association primitives.

The semantics of the reference's ``ORBmatcher`` search family
(ORBmatcher.cc — SearchByProjection, SearchByBoW, SearchForTriangulation,
Fuse): every search is (1) a boolean gate matrix built from projections /
windows / octave ranges, (2) a gated Hamming best + second-best + argmin
(``hamming.hamming_top2``, the CUDA kernel on the card), (3) a Lowe ratio
test, (4) an optional rotation-consistency histogram, (5) an optional
one-target-one-query dedupe. Results equal the JAX package's
``MatchResult`` exactly.

The gates, the search and its filters take optional leading batch axes (B
sequences tracked in one step, one Hamming launch for all B searches); an
unbatched call runs the same operations without them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import hamming

INVALID = -1
BIG = hamming.BIG


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (..., Nq) int32 target index or -1
    dist: torch.Tensor  # (..., Nq) int32 best distance (BIG where invalid)
    ok: torch.Tensor    # (..., Nq) bool

    @property
    def count(self):
        return self.ok.sum(-1, dtype=torch.int32)


def _masked(ok, idx, dist) -> MatchResult:
    return MatchResult(torch.where(ok, idx, torch.full_like(idx, INVALID)),
                       torch.where(ok, dist, torch.full_like(dist, BIG)), ok)


def window_gate(
    uv_proj: torch.Tensor,       # (..., Nq, 2) projected query positions
    uv_tgt: torch.Tensor,        # (..., Nt, 2) target keypoint positions
    radius: torch.Tensor,        # (..., Nq) per-query search radius (px)
) -> torch.Tensor:
    """|du| < r AND |dv| < r box gate (reference GetFeaturesInArea semantics,
    Frame.cc:432-485). Returns (..., Nq, Nt) bool."""
    du = (uv_proj[..., :, None, 0] - uv_tgt[..., None, :, 0]).abs()
    dv = (uv_proj[..., :, None, 1] - uv_tgt[..., None, :, 1]).abs()
    r = radius[..., :, None]
    return (du < r) & (dv < r)


def octave_gate(oct_q: torch.Tensor, oct_t: torch.Tensor, min_off: int,
                max_off: int) -> torch.Tensor:
    """Target octave within [oct_q + min_off, oct_q + max_off] — the
    forward/backward scale gating of SearchByProjection (ORBmatcher.cc:
    1770-1780). Returns (..., Nq, Nt) bool."""
    d = oct_t[..., None, :] - oct_q[..., :, None]
    return (d >= min_off) & (d <= max_off)


def best_matches(
    dist: torch.Tensor,           # (..., Nq, Nt) int32
    gate: torch.Tensor,           # (..., Nq, Nt) bool
    max_dist: int,
    nn_ratio: float | None = None,
) -> MatchResult:
    """Masked argmin with optional Lowe ratio test (best < ratio * second).
    Plain tensor ops: the line matcher's path (its distances are LBD)."""
    big = torch.full((), BIG, dtype=dist.dtype, device=dist.device)
    masked = torch.where(gate, dist, big)
    best, best_idx = masked.min(-1)
    best_idx = best_idx.to(torch.int32)
    ok = best <= max_dist
    if nn_ratio is not None:
        cols = torch.arange(masked.shape[-1], device=dist.device)
        second = torch.where(cols == best_idx[..., :, None], big, masked).amin(-1)
        ok = ok & (best.float() < nn_ratio * second.float())
    return _masked(ok, best_idx, best)


def rotation_consistency(
    angle_q: torch.Tensor,   # (..., Nq) degrees
    angle_t: torch.Tensor,   # (..., Nt) degrees
    m: MatchResult,
    histo_length: int = 30,
    keep_top: int = 3,
) -> MatchResult:
    """Keep only matches whose angle difference falls in the top-``keep_top``
    histogram bins (ORBmatcher.cc rotation histogram, :2035-2081)."""
    rot = angle_q - angle_t.gather(-1, m.idx.long().clamp(min=0))
    rot = torch.where(rot < 0, rot + 360.0, rot)
    binw = 360.0 / histo_length
    bins = (rot / binw).to(torch.int64).clamp(0, histo_length - 1)
    # one histogram per search of the batch
    lead = bins.shape[:-1]
    base = torch.arange(math.prod(lead), device=rot.device).reshape(lead + (1,))
    counts = torch.zeros(math.prod(lead) * histo_length, dtype=torch.int32, device=rot.device)
    counts = counts.index_add_(0, (base * histo_length + bins).reshape(-1),
                               m.ok.to(torch.int32).reshape(-1)).reshape(lead + (histo_length,))
    top_vals, top_idx = torch.sort(counts, descending=True, stable=True)
    # reference ind3 rule: drop 3rd (and 2nd) bin if much smaller than best
    keep2 = top_vals[..., 1:2].float() >= 0.1 * top_vals[..., 0:1].float()
    keep3 = top_vals[..., 2:3].float() >= 0.1 * top_vals[..., 0:1].float()
    in_top = (bins == top_idx[..., 0:1]) | (keep2 & (bins == top_idx[..., 1:2])) | (
        keep3 & (bins == top_idx[..., 2:3])
    )
    return _masked(m.ok & in_top, m.idx, m.dist)


def dedupe_targets(m: MatchResult, n_targets: int) -> MatchResult:
    """Enforce one query per target, keeping the lowest distance (the
    replace-if-better rule of e.g. ORBmatcher.cc:1846-1862), per search of
    the batch."""
    nq = m.idx.shape[-1]
    dev = m.idx.device
    qid = torch.arange(nq, dtype=torch.int64, device=dev)
    # composite key makes the winner unique even on distance ties
    d = torch.where(m.ok, m.dist, torch.full_like(m.dist, 511)).clamp(max=511).long()
    key = d * nq + qid
    sentinel = 511 * nq + nq  # larger than any valid key
    tgt = m.idx.long().clamp(0, n_targets - 1)
    best_key = torch.full(m.idx.shape[:-1] + (n_targets,), sentinel, dtype=torch.int64,
                          device=dev)
    best_key = best_key.scatter_reduce(
        -1, tgt, torch.where(m.ok, key, torch.full_like(key, sentinel)), "amin")
    return _masked(m.ok & (best_key.gather(-1, tgt) == key), m.idx, m.dist)


def match_descriptors(
    desc_q: torch.Tensor,
    desc_t: torch.Tensor,
    gate: torch.Tensor,
    max_dist: int,
    nn_ratio: float | None = None,
    angle_q: torch.Tensor | None = None,
    angle_t: torch.Tensor | None = None,
    histo_length: int = 30,
    dedupe: bool = True,
) -> MatchResult:
    """One-stop search: gated Hamming top-2 + ratio + rotation + dedupe.
    Leading axes of the queries, targets and gate are a batch of searches,
    one Hamming launch for all."""
    best, idx, second = hamming.hamming_top2(desc_q, desc_t, gate)
    ok = best <= max_dist
    if nn_ratio is not None:
        ok = ok & (best.float() < nn_ratio * second.float())
    m = _masked(ok, idx, best)
    if angle_q is not None and angle_t is not None:
        m = rotation_consistency(angle_q, angle_t, m, histo_length)
    if dedupe:
        m = dedupe_targets(m, desc_t.shape[-2])
    return m


def match_min_of_two(
    desc_q: torch.Tensor,    # (Nq, 32)
    desc_t2: torch.Tensor,   # (2, Nt, 32): two descriptors of each target
    gate: torch.Tensor,      # (Nq, Nt)
    max_dist: int,
    dedupe: bool = True,
) -> MatchResult:
    """Gated top-1 over the elementwise minimum of the two distance
    matrices, d(q, t) = min(d(q, desc_t2[0][t]), d(q, desc_t2[1][t])), as
    one batched Hamming launch with B = 2 and the same gate twice. The two
    rows combine exactly: best = min(b0, b1), and the index is that of the
    smaller best, or min(j0, j1) on a tie — the first minimum of the
    elementwise minimum, as an argmin over it gives; a row with nothing
    gated stays -1. No ratio test (a second-best of the minimum is not the
    minimum of the second-bests)."""
    g2 = gate[None].expand(2, *gate.shape).contiguous()
    best, idx, _ = hamming.hamming_top2_batched(desc_q, desc_t2, g2)
    b0, b1, j0, j1 = best[0], best[1], idx[0], idx[1]
    j = torch.where(b0 < b1, j0, torch.where(b1 < b0, j1, torch.minimum(j0, j1)))
    b = torch.minimum(b0, b1)
    m = _masked(b <= max_dist, j, b)
    return dedupe_targets(m, desc_t2.shape[1]) if dedupe else m


def match_descriptors_batched(
    desc_q: torch.Tensor,   # (Nq, 32) shared by the batch
    desc_t: torch.Tensor,   # (B, Nt, 32)
    gate: torch.Tensor,     # (B, Nq, Nt)
    max_dist: int,
    nn_ratio: float | None = None,
    dedupe: bool = True,
) -> MatchResult:
    """:func:`match_descriptors` over B target sets in one kernel launch
    (``hamming.hamming_top2_batched``); fields are (B, Nq), row b equal to
    ``match_descriptors(desc_q, desc_t[b], gate[b], ...)``. Dedupe runs per
    batch entry: target b*Nt + j of the flattened batch is target j of
    entry b, and the dedupe key orders queries within an entry as alone."""
    best, idx, second = hamming.hamming_top2_batched(desc_q, desc_t, gate)
    ok = best <= max_dist
    if nn_ratio is not None:
        ok = ok & (best.float() < nn_ratio * second.float())
    m = _masked(ok, idx, best)
    if not dedupe:
        return m
    B, nt = desc_t.shape[0], desc_t.shape[1]
    off = (torch.arange(B, dtype=torch.int32, device=idx.device) * nt)[:, None]
    flat = dedupe_targets(MatchResult((m.idx + off).reshape(-1), m.dist.reshape(-1),
                                      m.ok.reshape(-1)), B * nt)
    ok = flat.ok.reshape(m.ok.shape)
    return _masked(ok, m.idx, m.dist)
