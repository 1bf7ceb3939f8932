"""The plain reference of relocalization that decides ``correct`` where the
system relocalizes: plain PyTorch and numpy, importing nothing of the
program. It follows Tracking::Relocalization (Tracking.cc:2049-2269) as the
port implements it:

- the bag of words: each descriptor walks down the vocabulary tree to the
  child at the smallest Hamming distance, the lowest child on equal
  distances (TemplatedVocabulary::transform); tf-idf weights, L1-normalised;
- the keyframe database's candidates
  (KeyFrameDatabase::DetectRelocalizationCandidates): keyframes sharing more
  than 0.8 of the most shared words, L1 scores summed over each one's group
  (itself and its 10 best covisible keyframes), groups above 0.75 of the
  best sum, each represented by its best-scoring keyframe;
- the candidate match: the best and second Hamming distances of every
  feature of the frame against the candidate's features that hold a map
  point, at most 100 and under ``nn_ratio`` of the second, the rotation
  histogram's three fullest bins, one feature of the frame a target;
- the pose: a 3-point Kabsch RANSAC on the matches whose feature has depth,
  EPnP over every match when it keeps fewer than 12 inliers, then the pose
  LM on the 3D-2D matches;
- acceptance at 50 inliers of the LM.

Where it departs from ORB-SLAM2, it does as the port does: the match is
dense, not restricted to shared vocabulary nodes (SearchByBoW); the
histogram bins by floor(rotation / 12 degrees) where ORB-SLAM2 rounds
rotation / 30; the minimal solver is Horn's on 3D-3D pairs where ORB-SLAM2
runs EPnP throughout; there is no second, projection-guided pass for a
candidate short of 50 inliers (Tracking.cc:2160-2230); a group's best
keyframe is taken over all of its valid members, its sum over those that
share enough words. Where a ratio or share is compared, it is compared in
float32, as ORB-SLAM2's ``float`` arithmetic does.

RANSAC draws follow the port's convention: uniform draws from a
``torch.Generator`` on the device, seeded from (frame, candidate), the
3-point sets first, then EPnP's 6-point sets. Every solve takes the
precision it computes in; the pose LM is ``reference.pose_lm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference as ref

# float32 products on the card stay float32, not TF32 (the program sets the
# same when it is imported)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TH_HIGH = 100
HISTO_LENGTH = 30
ACCEPT_INLIERS = 50
EPNP_BELOW = 12
HORN_THRESH = 0.07
N_HYP = 256
EPNP_SET = 6
EPNP_CHI2 = 5.991


# ------------------------------------------------------------- bag of words
def bow(desc: torch.Tensor, valid: torch.Tensor, levels, idf: torch.Tensor,
        dist_dtype=torch.int32, dtype=torch.float64):
    """(word (N,) int64, bow (W,) in ``dtype``) of descriptors (N, 32):
    the tree walk, distances summed in ``dist_dtype``; tf counts the valid
    descriptors of a word."""
    k = levels[0].shape[0]
    lut = ref._POPCOUNT.to(desc.device)
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    child = torch.arange(k, device=desc.device)
    for lvl in levels:
        base = node * k
        x = lvl[base[:, None] + child[None, :]] ^ desc[:, None, :]
        d = lut[x.long()].to(dist_dtype).sum(-1, dtype=dist_dtype)
        node = base + torch.argmin(d, dim=1)
    tf = torch.zeros(idf.shape[0], dtype=dtype, device=desc.device)
    tf.index_add_(0, node, valid.to(dtype))
    v = tf * idf.to(dtype)
    norm = v.abs().sum()
    return node, v / norm if float(norm) > 0 else v


def reloc_candidates(query, bows: dict, valid, covisible, count_dtype=np.int64,
                     score_dtype=np.float64) -> list[int]:
    """Relocalization candidates of the sparse bow ``query`` (word ids,
    weights) against ``bows`` (keyframe -> (word ids, weights)) where
    ``valid[kf]``; ``covisible(kf, n)``: the keyframe's best ``n``
    covisible keyframes. Shared words are counted in ``count_dtype`` and
    scores summed in ``score_dtype``."""
    q = {int(w): float(v) for w, v in zip(*query)}
    shared, score = {}, {}
    for kf, (ids, vals) in bows.items():
        if not valid[kf]:
            continue
        common = [(int(w), float(v)) for w, v in zip(ids, vals) if int(w) in q]
        shared[kf] = int(np.array(len(common)).astype(count_dtype))
        score[kf] = float(np.sum([2.0 * min(q[w], v) for w, v in common], dtype=score_dtype))
    if not shared or max(shared.values()) <= 0:
        return []
    min_common = 0.8 * max(shared.values())
    cand = sorted(kf for kf, n in shared.items() if n > min_common)
    acc = []
    for c in cand:
        group = [c] + [g for g in covisible(c, 10) if valid[g]]
        s = lambda g: score.get(g, 0.0)  # noqa: E731
        eligible = [s(g) for g in group if shared.get(g, 0) > min_common] or [s(c)]
        best = max(group, key=lambda g: (s(g), -group.index(g)))
        acc.append((float(np.sum(eligible, dtype=score_dtype)), best))
    th = 0.75 * max(a for a, _ in acc)
    out = []
    for a, b in acc:
        if a > th and b not in out:
            out.append(b)
    return out


# ------------------------------------------------------------------ match
def rotation_filter(ok, idx, angle_q, angle_t, dtype=torch.float32) -> torch.Tensor:
    """``ok`` kept where the match's rotation falls in the histogram's
    fullest bin, or in the second and third fullest where they hold at least
    a tenth of the first (ORBmatcher::ComputeThreeMaxima, in float32); the
    lower bin first on equal counts."""
    rot = angle_q.to(dtype) - angle_t.to(dtype)[idx.clamp(min=0)]
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = (rot / (360.0 / HISTO_LENGTH)).to(torch.int64).clamp(0, HISTO_LENGTH - 1)
    counts = torch.bincount(bins[ok], minlength=HISTO_LENGTH).tolist()
    order = sorted(range(HISTO_LENGTH), key=lambda i: (-counts[i], i))
    tenth = np.float32(0.1) * np.float32(counts[order[0]])
    keep = [order[0]] + [i for i in order[1:3] if np.float32(counts[i]) >= tenth]
    return ok & torch.isin(bins, torch.tensor(keep, device=bins.device))


def reloc_match(q_desc, q_valid, q_angle, t_desc, t_angle, t_has, nn_ratio: float,
                dist_dtype=torch.int32) -> torch.Tensor:
    """The candidate keyframe's feature matched to each feature of the frame
    (-1 for none)."""
    gate = q_valid[:, None] & t_has[None, :]
    best, idx, second = ref.hamming_top2(q_desc, t_desc, gate, dist_dtype)
    ok = (best <= TH_HIGH) & (best.float() < nn_ratio * second.float())
    ok = rotation_filter(ok, idx, q_angle, t_angle)
    ok = ref.one_query_a_target(ok, idx, best)
    return torch.where(ok, idx, torch.full_like(idx, -1))


# ------------------------------------------------------------------- pose
def kabsch(src, dst, w=None):
    """(R, t) with dst ≈ R src + t, least squares over the rows (weights
    ``w``); src / dst (..., N, 3)."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = w.sum(-1, keepdim=True) + 1e-9
    cs = (src * w[..., None]).sum(-2) / wsum
    cd = (dst * w[..., None]).sum(-2) / wsum
    H = ((src - cs[..., None, :]) * w[..., None]).mT @ (dst - cd[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.mT
    d = torch.sign(torch.linalg.det(V @ U.mT))
    D = torch.ones(U.shape[:-1], dtype=src.dtype, device=src.device)
    D = torch.cat([D[..., :2], d[..., None]], -1)
    R = (V * D[..., None, :]) @ U.mT
    return R, cd - (R @ cs[..., None])[..., 0]


def horn_ransac(src, dst, valid, gen, dtype=torch.float64):
    """3-point Kabsch RANSAC of dst ≈ R src + t over ``valid`` rows, the
    first of the most inliers at 7 cm refit on its inliers at 7, 3.5, 1.75
    and 1.75 cm (floored at 1 cm) while a refit keeps a quarter of them (at
    least 8). Returns (R, t, n_inliers)."""
    src, dst = src.to(dtype), dst.to(dtype)
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices
    pool = valid.sum().clamp(min=3).float()
    u = torch.rand((N_HYP, 3), generator=gen, device=valid.device)
    sets = order[(u * pool).long().clamp(max=valid.shape[0] - 1)]
    Rs, ts = kabsch(src[sets], dst[sets])

    def inliers(R, t, th):
        r = torch.linalg.vector_norm(dst - (src @ R.mT + t[..., None, :]), dim=-1)
        return (r < th) & valid

    inl = inliers(Rs, ts, HORN_THRESH)
    b = int(torch.argmax(inl.sum(-1)))
    R, t, inl = Rs[b], ts[b], inl[b]
    for th in (HORN_THRESH, HORN_THRESH / 2, HORN_THRESH / 4, HORN_THRESH / 4):
        Rf, tf = kabsch(src, dst, inl.to(dtype))
        inl_f = inliers(Rf, tf, max(th, 0.01))
        if int(inl_f.sum()) >= max(int(inl.sum()) // 4, 8):
            R, t, inl = Rf, tf, inl_f
    return R, t, int(inl.sum())


def epnp(cam, pw, uv, w):
    """EPnP (Lepetit et al.) with the N=1 beta: control points at the
    weighted centroid and along the principal axes, the camera control
    points from the null vector of the 2N x 12 projection system, scaled to
    the world's inter-control distances and put in front of the camera, then
    Procrustes. Returns (R, t) world to camera."""
    wsum = w.sum(-1)[..., None] + 1e-9
    c0 = (pw * w[..., None]).sum(-2) / wsum
    cen = (pw - c0[..., None, :]) * w[..., None]
    ev, evec = torch.linalg.eigh(cen.mT @ cen / wsum[..., None])
    cw = torch.cat([c0[..., None, :],
                    c0[..., None, :] + evec.mT * ev.clamp(min=1e-12).sqrt()[..., None]], -2)
    base = (cw[..., 1:, :] - cw[..., :1, :]).mT
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device)
    a123 = (pw - cw[..., :1, :]) @ torch.linalg.inv(base + 1e-12 * eye).mT
    a = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)
    z = torch.zeros_like(a)
    du, dv = (cam.cx - uv[..., 0])[..., None], (cam.cy - uv[..., 1])[..., None]
    shape = a.shape[:-1] + (12,)
    rows = torch.cat([torch.stack([a * cam.fx, z, a * du], -1).reshape(shape),
                      torch.stack([z, a * cam.fy, a * dv], -1).reshape(shape)], -2)
    rows = rows * torch.cat([w, w], -1).clamp(min=0).sqrt()[..., None]
    v = torch.linalg.eigh(rows.mT @ rows)[1][..., 0].reshape(a.shape[:-2] + (4, 3))
    dw = torch.linalg.vector_norm(cw[..., :, None, :] - cw[..., None, :, :], dim=-1)
    dc = torch.linalg.vector_norm(v[..., :, None, :] - v[..., None, :, :], dim=-1)
    beta = (dc * dw).sum((-1, -2)) / ((dc ** 2).sum((-1, -2)) + 1e-12)
    cc = beta[..., None, None] * v
    front = ((a @ cc)[..., 2] * w).sum(-1)
    cc = cc * torch.where(front < 0, -1.0, 1.0).to(pw.dtype)[..., None, None]
    return kabsch(cw, cc)


def epnp_ransac(cam, pw, uv, valid, gen, dtype=torch.float64):
    """EPnP on 256 sets of 6 distinct valid matches, the first of the most
    inliers at chi-square 5.991 px², refit on its inliers if that keeps at
    least as many."""
    pw, uv = pw.to(dtype), uv.to(dtype)
    keys = torch.rand((N_HYP, valid.shape[0]), generator=gen, device=valid.device)
    sets = torch.topk(torch.where(valid, keys, torch.full_like(keys, -1.0)), EPNP_SET).indices

    def inliers(R, t):
        pc = pw @ R.mT + t[..., None, :]
        zc = pc[..., 2]
        zs = torch.where(zc.abs() > 1e-6, zc, torch.full_like(zc, 1e-6))
        e = (cam.fx * pc[..., 0] / zs + cam.cx - uv[:, 0]) ** 2 + \
            (cam.fy * pc[..., 1] / zs + cam.cy - uv[:, 1]) ** 2
        return (zc > 0.05) & (e <= EPNP_CHI2) & valid

    Rs, ts = epnp(cam, pw[sets], uv[sets], torch.ones(sets.shape, dtype=dtype, device=pw.device))
    inl = inliers(Rs, ts)
    b = int(torch.argmax(inl.sum(-1)))
    R1, t1 = epnp(cam, pw, uv, inl[b].to(dtype))
    if int(inliers(R1, t1).sum()) >= int(inl[b].sum()):
        return R1, t1
    return Rs[b], ts[b]


def backproject(cam, uv, depth):
    return torch.stack([(uv[:, 0] - cam.cx) / cam.fx * depth,
                        (uv[:, 1] - cam.cy) / cam.fy * depth, depth], -1)


def pose_obs(fd: dict, idx, kf_pt_w, scale: float) -> dict:
    """The pose LM's problem of the matches ``idx`` (no lines): the matched
    map points observed at the frame's features."""
    ok = idx >= 0
    dev = kf_pt_w.device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    return {"p3d": kf_pt_w[idx.clamp(min=0)], "uv": fd["kp_xy_un"],
            "u_right": torch.where(ok, fd["kp_ur"], torch.full_like(fd["kp_ur"], -1.0)),
            "inv_sigma2": (1.0 / scale ** 2) ** fd["kp_octave"].double(), "valid": ok,
            "line_nw": z(1, 3), "line_vw": z(1, 3), "line_uv": z(1, 2, 2),
            "line_inv_sigma2": torch.ones(1, dtype=torch.float32, device=dev),
            "line_valid": torch.zeros(1, dtype=torch.bool, device=dev)}


def lm_inliers(cam, R, t, obs: dict) -> int:
    """Matches within the pose LM's chi-square gates at (R, t)."""
    R, t = R.double(), t.double()
    pc = obs["p3d"].double() @ R.T + t
    zc = pc[:, 2]
    zs = torch.where(zc.abs() > 1e-6, zc, torch.full_like(zc, 1e-6))
    u = cam.fx * pc[:, 0] / zs + cam.cx
    v = cam.fy * pc[:, 1] / zs + cam.cy
    ur = obs["u_right"].double()
    stereo = ur >= 0
    e = (u - obs["uv"][:, 0]) ** 2 + (v - obs["uv"][:, 1]) ** 2 + \
        torch.where(stereo, (u - cam.bf / zs - ur) ** 2, torch.zeros_like(u))
    c = e * obs["inv_sigma2"].double()
    gate = torch.where(stereo, ref.CHI2_STEREO, ref.CHI2_MONO)
    return int(((c <= gate) & (zc > 1e-6) & obs["valid"]).sum())


def reloc_pose(cam, scale: float, fd: dict, idx, kf_pt_w, seed: int, dtype=torch.float64,
               ransac_dtype=torch.float64):
    """(R, t, n_inliers) of one candidate try from the matches ``idx``: the
    RANSAC drawn from a generator seeded with ``seed`` on the matches'
    device, then the pose LM in ``dtype``."""
    dev = kf_pt_w.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ok = idx >= 0
    dst = kf_pt_w[idx.clamp(min=0)]
    src = backproject(cam, fd["kp_xy_un"].to(ransac_dtype), fd["kp_depth"].to(ransac_dtype))
    R_wc, t_wc, n = horn_ransac(src, dst, ok & (fd["kp_depth"] > 0), gen, ransac_dtype)
    R0, t0 = R_wc.T, -(R_wc.T @ t_wc)
    if n < EPNP_BELOW:
        R0, t0 = epnp_ransac(cam, dst, fd["kp_xy_un"], ok, gen, ransac_dtype)
    obs = pose_obs(fd, idx, kf_pt_w, scale)
    R, t = ref.pose_lm(cam, R0, t0, obs, 4, 10, dtype)
    return R, t, lm_inliers(cam, R, t, obs)


def centre_gap_mm(Ra, ta, Rb, tb) -> float:
    """Distance between the camera centres of two world-to-camera poses."""
    ca = -(Ra.double().T @ ta.double())
    cb = -(Rb.double().T @ tb.double())
    return float(torch.linalg.vector_norm(ca - cb)) * 1e3


def rotation_deg(Ra, Rb) -> float:
    c = (float(torch.trace(Ra.double().T @ Rb.double())) - 1.0) / 2.0
    return math.degrees(math.acos(max(-1.0, min(1.0, c))))
