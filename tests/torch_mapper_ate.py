"""ATE of the two packages' trackers with a synchronous LocalMapper, and
what the first local BA does to the keyframes (not a test module).

    JAX_PLATFORMS=cpu python tests/torch_mapper_ate.py [N_FRAMES] [--jax-f64]

Tracks the first N_FRAMES (default 150) of the room orbit that
``chip_smoke.py`` uses, at 320x240 on the CPU, through ``Tracker`` with a
synchronous ``LocalMapper`` in the JAX package and in the port, and prints
for each: keyframes, the frames at which local BA ran, and the ATE (RMSE /
max, cm, Horn-aligned camera centres) as tracked and as healed. For the
first local BA of each package it prints the keyframe centres' errors
against ground truth before and after BA, and the BA cost at the
ground-truth poses (landmarks free) against the cost at the BA optimum,
both solved by the port's float64 BA on that package's problem.
``--jax-f64`` runs the JAX package's BA in float64 (as the port solves).
"""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from plslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from plslam_tpu.geometry.projection import Camera as JCamera  # noqa: E402
from plslam_tpu.models import tracking as jtracking  # noqa: E402
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper  # noqa: E402
from plslam_tpu.models.map import SlamMap as JSlamMap  # noqa: E402
from plslam_tpu.optim import local_ba as jlba  # noqa: E402
from plslam_torch import convert  # noqa: E402
from plslam_torch.models import tracking as ttracking  # noqa: E402
from plslam_torch.models.local_mapping import LocalMapper  # noqa: E402
from plslam_torch.models.map import SlamMap  # noqa: E402
from plslam_torch.optim import local_ba as tlba  # noqa: E402
from plslam_torch.utils.synthetic import smooth_trajectory  # noqa: E402
from torch_parity import KW, jax_ba_in_float64, render  # noqa: E402

TOTAL = 300  # the orbit's length: chip_smoke.py's 150 frames are its first half


def ate_cm(est, gt):
    a, b = est.T.astype(np.float64), gt.T.astype(np.float64)
    ca, cb = a.mean(1, keepdims=True), b.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((a - ca) @ (b - cb).T)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1
    err = np.linalg.norm(Vt.T @ S @ U.T @ (a - ca) + cb - b, axis=0)
    return float(np.sqrt((err**2).mean())) * 100, float(err.max()) * 100


def centers(traj):
    return np.array([-(R.T @ t) for _, R, t in traj])


def _numpy(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def first_ba_report(name, prob, kf_frames, gt_poses, cam, iters):
    """Keyframe errors against ground truth (in the first camera's frame,
    the trackers' world) before and after BA, and the cost at the
    ground-truth poses against the optimum's."""
    R0, t0 = gt_poses[0]
    solve = lambda p: _numpy(tlba.bundle_adjust_stepped(  # noqa: E731
        cam, convert.ba_problem_from_numpy(p, device="cpu"), **iters))
    res = solve(prob)
    at_gt = dict(prob, cam_R=prob["cam_R"].copy(), cam_t=prob["cam_t"].copy(),
                 cam_fixed=np.ones_like(prob["cam_fixed"]))
    for i, f in enumerate(kf_frames):
        R, t = gt_poses[f]
        at_gt["cam_R"][i] = R @ R0.T
        at_gt["cam_t"][i] = t - R @ R0.T @ t0
        c_gt = R0 @ (-R.T @ t) + t0
        before = -prob["cam_R"][i].T @ prob["cam_t"][i]
        after = -res["cam_R"][i].T @ res["cam_t"][i]
        print(f"{name} first BA, keyframe {i} (frame {f}): error {1e3 * np.linalg.norm(before - c_gt):.2f}"
              f" mm before BA, {1e3 * np.linalg.norm(after - c_gt):.2f} mm after")
    print(f"{name} first BA cost: {float(solve(at_gt)['cost']):.3f} at the ground-truth poses, "
          f"{float(res['cost']):.3f} at the optimum")


def first_ba_cross_check(jax_first, jax_res, port_prob, cam):
    """Where the two packages' first BA results part: the port's BA on
    JAX's problem against JAX's result, the two problems' line sets, and
    the two problems solved without lines."""
    _, jprob, kw = jax_first
    iters = dict(iters1=kw["iters1"], iters2=kw["iters2"])
    n = int(jprob["cam_valid"].sum())

    def solve(p, lines=True):
        if not lines:
            p = dict(p, ln_valid=np.zeros_like(p["ln_valid"]),
                     lobs_valid=np.zeros_like(p["lobs_valid"]))
        return _numpy(tlba.bundle_adjust_stepped(
            cam, convert.ba_problem_from_numpy(p, device="cpu"), **iters))

    def gap_mm(a, b):
        ca = np.array([-a["cam_R"][i].T @ a["cam_t"][i] for i in range(n)])
        cb = np.array([-b["cam_R"][i].T @ b["cam_t"][i] for i in range(n)])
        return 1e3 * np.linalg.norm(ca - cb, axis=1).max()

    print(f"first BA: the port's BA on JAX's problem lands {gap_mm(solve(jprob), jax_res):.6f} mm "
          f"from JAX's result; the two packages' own results are "
          f"{gap_mm(solve(port_prob), jax_res):.3f} mm apart")
    print(f"first BA problems: {int(jprob['ln_valid'].sum())} lines / "
          f"{int(jprob['lobs_valid'].sum())} line observations (JAX), "
          f"{int(port_prob['ln_valid'].sum())} / {int(port_prob['lobs_valid'].sum())} (port); "
          f"point observations {int(jprob['obs_valid'].sum())} and "
          f"{int(port_prob['obs_valid'].sum())}; solved without lines the two are "
          f"{gap_mm(solve(jprob, False), solve(port_prob, False)):.6f} mm apart")


def main(n, jax_f64):
    frames = render(n, total=TOTAL)
    gt_poses = smooth_trajectory(TOTAL)[:n]
    gt = np.array([-(R.T @ t) for R, t in gt_poses])
    jcfg = JSlamConfig(camera=JCamera(**KW))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    probs = {"jax": [], "port": []}
    jax_results = []
    frame = [0]
    ctx = jax_ba_in_float64() if jax_f64 else contextlib.nullcontext()
    with ctx:
        inner_j, inner_t = jlba.bundle_adjust_stepped, tlba.bundle_adjust_stepped

        def jcap(cam, prob, **kw):
            res = inner_j(cam, prob, **kw)
            probs["jax"].append((frame[0], _numpy(prob), kw))
            jax_results.append(_numpy(res))
            return res

        def tcap(cam, prob, **kw):
            probs["port"].append((frame[0], _numpy(prob), kw))
            return inner_t(cam, prob, **kw)

        tcap.runs = inner_t.runs  # the port's function counts its calls here
        jlba.bundle_adjust_stepped, tlba.bundle_adjust_stepped = jcap, tcap
        try:
            jm = JSlamMap(jcfg)
            jt = jtracking.Tracker(jcfg, jm, local_mapper=JLocalMapper(jcfg, jm))
            m = SlamMap(cfg, device="cpu")
            tr = ttracking.Tracker(cfg, m, local_mapper=LocalMapper(cfg, m))
            for i, (g, d) in enumerate(frames):
                frame[0] = i
                jt.process(g, d, i / 30.0)
                tr.process(g, d, i / 30.0)
            jt.flush()
            tr.flush()
        finally:
            jlba.bundle_adjust_stepped, tlba.bundle_adjust_stepped = inner_j, inner_t
    tcam = convert.Camera(**KW)
    for name, t, mm in (("jax", jt, jm), ("port", tr, m)):
        kf_frames = [int(f) for f in mm.kf_frame_id[:mm.n_kf]]
        print(f"{name}: {len(t.trajectory)} frames, keyframes at frames {kf_frames} "
              f"({int(np.sum(mm.kf_valid[:mm.n_kf]))} survive culling), local BA at frames "
              f"{[f for f, _, _ in probs[name]]}, {mm.n_points()} points, {mm.n_lines()} lines")
        tr_ate, he_ate = ate_cm(centers(t.trajectory), gt), ate_cm(centers(t.healed_trajectory()), gt)
        print(f"{name} ATE cm (RMSE / max): tracked {tr_ate[0]:.4f} / {tr_ate[1]:.4f}, "
              f"healed {he_ate[0]:.4f} / {he_ate[1]:.4f}")
        if probs[name]:
            _, prob, kw = probs[name][0]
            iters = dict(iters1=kw["iters1"], iters2=kw["iters2"])
            n_cams = int(prob["cam_valid"].sum())
            first_ba_report(name, prob, kf_frames[:n_cams], gt_poses, tcam, iters)
    if probs["jax"] and probs["port"]:
        first_ba_cross_check(probs["jax"][0], jax_results[0], probs["port"][0][1], tcam)
    for what, a, b in (("tracked", centers(jt.trajectory), centers(tr.trajectory)),
                       ("healed", centers(jt.healed_trajectory()),
                        centers(tr.healed_trajectory()))):
        print(f"largest per-frame gap between the packages, {what}: "
              f"{1e3 * np.linalg.norm(a - b, axis=1).max():.3f} mm")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 150, "--jax-f64" in sys.argv)
