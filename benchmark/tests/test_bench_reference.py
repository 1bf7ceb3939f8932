"""The plain reference against the program's own plain CPU paths, at small
sizes: the two are written independently and must agree where the
arithmetic is the same, and the control (the reference in the precision
below) must not."""

import numpy as np
import torch

from benchmark import reference as ref
from benchmark import scene
from plslam_torch.config import OrbConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.ops import fast, hamming, image, orb
from plslam_torch.optim import pose

ORB = dict(n_features=1000, scale_factor=1.2, n_levels=8, ini_th_fast=20, min_th_fast=7,
           cell_size=32, max_kp_per_cell=8, edge_threshold=19)
CAM = Camera(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, bf=40.0,
             width=320, height=240)


def _frame(seed=0, i=0):
    R, t = scene.path_poses([i], 600)
    g, _ = scene.Room(seed, "cpu").render(CAM, torch.tensor(R, dtype=torch.float32),
                                           torch.tensor(t, dtype=torch.float32))
    return g[0].clamp(0, 255).to(torch.uint8)


def test_fast_equals_the_program_on_the_same_level():
    img = ref.unquantize_gray(_frame(), 6)
    for lvl in image.build_pyramid(img, 8, 1.2):
        assert torch.equal(ref.fast_score_nms(lvl, 7.0), fast.fast_score_nms_plain(lvl, 7.0))


def test_pyramid_agrees_to_rounding():
    img = ref.unquantize_gray(_frame(), 6)
    for a, b in zip(ref.pyramid(img, 8, 1.2), image.build_pyramid(img, 8, 1.2)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) < 1e-3


def test_orb_agrees_and_bf16_does_not():
    g = _frame(2, 100)
    img = ((g.int() >> 2) << 2) + 2
    feats = orb.extract_orb(img.float(), OrbConfig())
    v = feats.valid
    lvl = feats.octave[v].long()
    s = torch.tensor([1.2 ** l for l in range(8)], dtype=torch.float64)[lvl]
    prog = {(int(o), int(y), int(x)): d for o, y, x, d in zip(
        lvl, torch.round(feats.xy[v, 1].double() / s), torch.round(feats.xy[v, 0].double() / s),
        feats.desc[v])}
    for dtype, most in ((torch.float32, 1e-3), (torch.bfloat16, None)):
        _, kp = ref.orb(g, ORB, 6, dtype)
        mine = {(int(o), int(y), int(x)): d for o, y, x, d in
                zip(kp["level"], kp["y"], kp["x"], kp["desc"])}
        common = prog.keys() & mine.keys()
        miss = 1 - 2 * len(common) / (len(prog) + len(mine))
        bits = sum(int(np.unpackbits((prog[k] ^ mine[k]).numpy()).sum()) for k in common)
        share = bits / (256 * len(common))
        if most is not None:
            assert miss <= most and share <= most, (miss, share)
        else:
            assert miss > 0.01 and share > 0.005, (miss, share)


def test_hamming_equals_the_program():
    gen = torch.Generator().manual_seed(5)
    q = torch.randint(0, 256, (64, 32), dtype=torch.uint8, generator=gen)
    t = torch.randint(0, 256, (300, 32), dtype=torch.uint8, generator=gen)
    t[7] = q[3]  # an exact match
    t[8] = q[3]  # and a tie with it
    gate = torch.rand(64, 300, generator=gen) < 0.1
    gate[3, 7] = gate[3, 8] = True
    gate[10] = False  # a row with nothing gated
    want = hamming.hamming_top2_plain(q, t, gate)
    got = ref.hamming_top2(q, t, gate)
    for w, g in zip(want, got):
        assert torch.equal(w.long(), g)
    low = ref.hamming_top2(q, t, gate, torch.int8)
    assert not torch.equal(low[0], got[0])


def _pose_problem(seed=0):
    rng = np.random.default_rng(seed)
    R, t = scene.path_poses([37], 600)
    R, t = R[0], t[0]
    n, nl = 300, 40
    pc = np.c_[rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(0.8, 4.0, n)]
    pw = (pc - t) @ R
    u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx + rng.normal(0, 0.7, n)
    v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy + rng.normal(0, 0.7, n)
    ur = u - CAM.bf / pc[:, 2] + rng.normal(0, 0.7, n)
    ur[::3] = -1.0
    u[:20] += 40.0  # outliers
    a = np.c_[rng.uniform(-1, 1, (nl, 2)), rng.uniform(1, 3, nl)]
    b = a + rng.normal(0, 0.4, (nl, 3))
    aw, bw = (a - t) @ R, (b - t) @ R
    ep = np.stack([np.c_[CAM.fx * p[:, 0] / p[:, 2] + CAM.cx, CAM.fy * p[:, 1] / p[:, 2] + CAM.cy]
                   for p in (a, b)], 1) + rng.normal(0, 0.5, (nl, 2, 2))
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    obs = pose.PoseObs(p3d=f32(pw), uv=f32(np.c_[u, v]), u_right=f32(ur),
                       inv_sigma2=f32(1.2 ** (-2.0 * rng.integers(0, 3, n))),
                       valid=torch.ones(n, dtype=torch.bool),
                       line_nw=f32(np.cross(aw, bw)), line_vw=f32(bw - aw), line_uv=f32(ep),
                       line_inv_sigma2=torch.ones(nl), line_valid=torch.ones(nl, dtype=torch.bool))
    dR = scene._so3_exp(np.array([[0.01, -0.02, 0.015]]))[0]
    return f32(dR @ R), f32(t + np.array([0.02, -0.01, 0.03])), obs


def test_pose_lm_reaches_the_program_and_bf16_does_not():
    for seed in range(3):
        R0, t0, obs = _pose_problem(seed)
        prog = pose.optimize_pose(CAM, R0, t0, obs)
        o = {k: getattr(obs, k) for k in obs._fields}
        centre = lambda R, t: -(R.double().T @ t.double())  # noqa: E731
        R64, t64 = ref.pose_lm(CAM, R0, t0, o, dtype=torch.float64)
        gap = float(torch.linalg.vector_norm(centre(prog.R, prog.t) - centre(R64, t64)))
        assert gap < 2e-5, gap  # float32 against float64: hundredths of a millimetre
        Rb, tb = ref.pose_lm(CAM, R0, t0, o, dtype=torch.bfloat16)
        low = float(torch.linalg.vector_norm(centre(Rb, tb) - centre(R64, t64)))
        assert low > 10 * gap and low > 5e-4, (low, gap)
