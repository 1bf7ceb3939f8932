"""Monocular two-view bootstrap: batched H / F RANSAC and reconstruction.

The port of the JAX package's ``ops/initializer.py``, the reference's
``Initializer`` (Initializer.cc): the reference RANSACs a homography and a
fundamental matrix on two host threads (:104-105), scores both with
symmetric transfer errors (CheckHomography / CheckFundamental, :181-461)
and picks by SH / (SH + SF) > 0.40 (:129-136, in the tracker here);
``ReconstructF`` decomposes the essential matrix into 4 motions and keeps
the one with a clear cheirality winner (:484-733), ``ReconstructH`` runs
the Faugeras 8-motion decomposition; DLT triangulation (:734-795) and
CheckRT (:798-907) gate the winner.

Each model's hypotheses are ONE batched solve (256 minimal sets: 4-point
DLT for H, normalised 8-point for F, both the null vector of a batched
SVD), scored as one (hypotheses x N) batch with the first maximum winning,
as in the JAX package; the reconstructions check every motion in one batch.
Hypothesis sets are drawn without replacement among the valid rows from a
``torch.Generator``, or injected (``samples``), as the parity tests do with
the JAX package's own draws.
"""

from __future__ import annotations

import torch

CHI2_H = 5.991
CHI2_F = 3.84
SCORE_TH = 5.991  # both scores accumulate (SCORE_TH - chi2)
N_HYP = 256


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalisation over the valid rows (Initializer::Normalize,
    :909-960): returns (normalised uv, T (3, 3))."""
    w = valid.float()
    n = w.sum().clamp(min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    dev = ((uv - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / dev.clamp(min=1e-9)
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    one = torch.ones((), dtype=uv.dtype, device=uv.device)
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (uv - mean) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of each
    (…, k, 9) matrix, as (…, 3, 3) float64.

    Solved in float64: on a normalised minimal set a float32 SVD puts the
    null vector ~5e-5 (relative) off the float64 one, in LAPACK and in the
    JAX package alike, so two float32 solves differ by ~1e-4 and the card's
    batched SVD differs from LAPACK in its last bits besides."""
    _, _, vt = torch.linalg.svd(A.double())
    return vt[..., 8, :].reshape(A.shape[:-2] + (3, 3))


def _dlt_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """H from 4 correspondences (…, 4, 2): the null vector of (…, 8, 9)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    A = torch.stack([r1, r2], -2).reshape(p1.shape[:-2] + (8, 9))  # rows r1_0, r2_0, r1_1, …
    return _null_vector(A).to(p1.dtype)


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """F from 8 correspondences (…, 8, 2), rank 2 enforced."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], -1)
    U, S, Vt = torch.linalg.svd(_null_vector(A))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return ((U * S[..., None, :]) @ Vt).to(p1.dtype)


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], -1)


def _sym_err_h(H: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """Symmetric transfer chi2 of H (…, 3, 3) on (N, 2) pairs
    (CheckHomography, :181-288): (…, N) each way."""
    Hinv = torch.linalg.inv(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device))

    def xfer(M, a, b):
        h = _homogeneous(a) @ M.mT
        w = torch.where(h[..., 2].abs() > 1e-9, h[..., 2], torch.full_like(h[..., 2], 1e-9))
        p = h[..., :2] / w[..., None]
        return ((p - b) ** 2).sum(-1)

    return xfer(H, uv1, uv2), xfer(Hinv, uv2, uv1)


def _sym_err_f(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """Point-to-epipolar-line chi2 both ways (CheckFundamental, :290-398)."""
    h1 = _homogeneous(uv1)
    h2 = _homogeneous(uv2)
    l2 = h1 @ F.mT
    l1 = h2 @ F
    d2 = (l2 * h2).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp(min=1e-9)
    d1 = (l1 * h1).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp(min=1e-9)
    return d1, d2


def draw_samples(valid: torch.Tensor, n_hyp: int, size: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_hyp, size) distinct row indices, each set uniform among the valid
    rows: the ``size`` largest of uniform keys, invalid rows last."""
    keys = torch.rand((n_hyp, valid.shape[0]), generator=generator, device=valid.device)
    keys = torch.where(valid, keys, torch.full_like(keys, -1.0))
    return torch.topk(keys, size, dim=1).indices


def find_models(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator | None = None,
                samples: tuple[torch.Tensor, torch.Tensor] | None = None):
    """RANSAC H and F over the pairs (uv1[i], uv2[i]), valid (N,).

    ``samples`` = (h_idx (N_HYP, 4), f_idx (N_HYP, 8)) row indices; drawn
    from ``generator`` unless given. Returns (H, score_h, F, score_f,
    inliers_h, inliers_f) of the best hypothesis of each model (the first
    maximum of the score)."""
    if samples is None:
        samples = (draw_samples(valid, N_HYP, 4, generator),
                   draw_samples(valid, N_HYP, 8, generator))
    h_idx, f_idx = (s.long() for s in samples)
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    Hs = torch.linalg.inv(T2) @ _dlt_h(n1[h_idx], n2[h_idx]) @ T1
    # h2n^T Fn h1n = 0 with h*n = T* h*  =>  F = T2^T Fn T1
    Fs = T2.T @ _eight_point(n1[f_idx], n2[f_idx]) @ T1

    c1, c2 = _sym_err_h(Hs, uv1, uv2)                                   # (hyp, N)
    okh = (c1 < CHI2_H) & (c2 < CHI2_H) & valid
    zero = torch.zeros_like(c1)
    sh = torch.where(okh, (SCORE_TH - c1) + (SCORE_TH - c2), zero).sum(-1)
    c1, c2 = _sym_err_f(Fs, uv1, uv2)
    okf = (c1 < CHI2_F) & (c2 < CHI2_F) & valid
    s = (torch.where((c1 < CHI2_F) & valid, SCORE_TH - c1, zero)
         + torch.where((c2 < CHI2_F) & valid, SCORE_TH - c2, zero))
    sf = torch.where(okf, s, zero).sum(-1)
    bh = torch.argmax(sh)  # first maximum
    bf = torch.argmax(sf)
    return Hs[bh], sh[bh], Fs[bf], sf[bf], okh[bh], okf[bf]


def _triangulate(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                 uv2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of (N, 2) pairs under the projections P1 (3, 4)
    and P2 (…, 3, 4): (…, N, 3)."""
    P1 = P1.expand_as(P2)
    A = torch.stack([
        uv1[:, 0:1] * P1[..., None, 2, :] - P1[..., None, 0, :],
        uv1[:, 1:2] * P1[..., None, 2, :] - P1[..., None, 1, :],
        uv2[:, 0:1] * P2[..., None, 2, :] - P2[..., None, 0, :],
        uv2[:, 1:2] * P2[..., None, 2, :] - P2[..., None, 1, :],
    ], -2)                                                              # (…, N, 4, 4)
    _, _, vt = torch.linalg.svd(A)
    Xh = vt[..., 3, :]
    w = Xh[..., 3]
    w = torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
    return Xh[..., :3] / w[..., None]


def _check_rt(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, uv1: torch.Tensor,
              uv2: torch.Tensor, ok: torch.Tensor):
    """CheckRT (:798-907) for the motions R (M, 3, 3), t (M, 3): triangulate,
    gate cheirality, parallax and reprojection. Returns (n_good (M,),
    good (M, N), p3d (M, N, 3))."""
    P1 = K @ torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                        torch.zeros((3, 1), dtype=K.dtype, device=K.device)], -1)
    P2 = K @ torch.cat([R, t[..., None]], -1)
    pw = _triangulate(P1, P2, uv1, uv2)
    z1 = pw[..., 2]
    z2 = (pw @ R.mT + t[:, None, :])[..., 2]
    c2 = -(R.mT @ t[..., None])[..., 0]
    r2 = pw - c2[:, None, :]
    d1 = torch.linalg.vector_norm(pw, dim=-1)
    d2 = torch.linalg.vector_norm(r2, dim=-1)
    cos_par = (pw * r2).sum(-1) / (d1 * d2).clamp(min=1e-9)

    def reproj(P, uv):
        h = pw @ P[..., :3].mT + P[..., None, :, 3]
        w = torch.where(h[..., 2].abs() > 1e-9, h[..., 2], torch.full_like(h[..., 2], 1e-9))
        return ((h[..., :2] / w[..., None] - uv) ** 2).sum(-1)

    e1 = reproj(P1, uv1)
    e2 = reproj(P2, uv2)
    good = (ok & (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
            & (e1 < 4.0 * CHI2_H) & (e2 < 4.0 * CHI2_H))
    return good.sum(-1), good, pw


def _pick(cands_R, cands_t, K, uv1, uv2, ok):
    """The motion with the most good points (the first on ties) and whether
    it is a clear winner: at least max(0.7 of the inliers, 30) good points
    and the runner-up under 0.75 of it."""
    n, good, pw = _check_rt(K, cands_R, cands_t, uv1, uv2, ok)
    best = torch.argmax(n)
    n_best = n[best]
    second = torch.sort(n).values[-2]
    clear = ((n_best >= (0.7 * ok.sum().float()).clamp(min=30))
             & (second < 0.75 * n_best))
    return cands_R[best], cands_t[best], pw[best], good[best], clear


def reconstruct_f(F: torch.Tensor, K: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                  ok: torch.Tensor):
    """The 4-motion essential decomposition and the winner (ReconstructF
    :484-733, DecomposeE :909). Returns (R, t, p3d (N, 3), good (N,),
    clear)."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0., -1., 0.], [1., 0., 0.], [0., 0., 1.]], dtype=F.dtype,
                     device=F.device)

    def fix(R):
        return R * torch.sign(torch.linalg.det(R))

    R1 = fix(U @ W @ Vt)
    R2 = fix(U @ W.T @ Vt)
    tt = U[:, 2]
    tt = tt / torch.linalg.vector_norm(tt).clamp(min=1e-9)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([tt, -tt, tt, -tt])
    return _pick(cands_R, cands_t, K, uv1, uv2, ok)


def reconstruct_h(H: torch.Tensor, K: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                  ok: torch.Tensor):
    """The Faugeras decomposition of K^-1 H K into 8 motions and the winner
    (ReconstructH). Returns (R, t, p3d (N, 3), good (N,), clear)."""
    A = torch.linalg.inv(K) @ H @ K
    U, S, Vt = torch.linalg.svd(A)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    tiny = 1e-12
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3).clamp(min=tiny)).clamp(min=0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3).clamp(min=tiny)).clamp(min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0.0))
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    # d' = d2
    aux_st = root / ((d1 + d3) * d2).clamp(min=tiny)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=tiny)
    sts = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    # d' = -d2
    aux_sp = root / ((d1 - d3) * d2).clamp(min=tiny)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=tiny)
    sps = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])

    Rs, ts = [], []
    for i in range(4):
        Rp = torch.stack([torch.stack([ct, zero, -sts[i]]), torch.stack([zero, one, zero]),
                          torch.stack([sts[i], zero, ct])])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ (torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3)))
    for i in range(4):
        Rp = torch.stack([torch.stack([cp, zero, sps[i]]), torch.stack([zero, -one, zero]),
                          torch.stack([sps[i], zero, -cp])])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ (torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3)))
    cands_R = torch.stack(Rs)
    cands_t = torch.stack(ts)
    cands_t = cands_t / torch.linalg.vector_norm(cands_t, dim=-1, keepdim=True).clamp(min=1e-9)
    return _pick(cands_R, cands_t, K, uv1, uv2, ok)
