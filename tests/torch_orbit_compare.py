"""The loop orbit of tests/test_loop_closing.py in both packages on the CPU
(not a test module).

    JAX_PLATFORMS=cpu python tests/torch_orbit_compare.py [N_FRAMES] [--no-loop]

Tracks the first N_FRAMES (default 150) of the orbit of RoomScene(3) at
320x240, points and lines, keyframe culling off, through ``Tracker`` with a
synchronous ``LocalMapper`` and (unless ``--no-loop``) a synchronous
``LoopCloser``, in the JAX package and in the port, frame by frame on the
same images. For each package it prints the keyframes' KF0-relative errors
against ground truth (cm; tests/test_loop_closing.py's anchor error of each
keyframe against keyframe 0) before and after every loop correction and at
the end, and the tracked poses' error against the first frame every 10
frames.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from plslam_tpu.bow.database import KeyFrameDatabase as JKeyFrameDatabase  # noqa: E402
from plslam_tpu.bow.vocabulary import Vocabulary as JVocabulary  # noqa: E402
from plslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from plslam_tpu.geometry.projection import Camera as JCamera  # noqa: E402
from plslam_tpu.models import loop_closing as jloop  # noqa: E402
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper  # noqa: E402
from plslam_tpu.models.map import SlamMap as JSlamMap  # noqa: E402
from plslam_tpu.models.tracking import Tracker as JTracker  # noqa: E402
from plslam_torch import convert  # noqa: E402
from plslam_torch.bow.database import KeyFrameDatabase  # noqa: E402
from plslam_torch.bow.vocabulary import Vocabulary  # noqa: E402
from plslam_torch.models import loop_closing as tloop  # noqa: E402
from plslam_torch.models.local_mapping import LocalMapper  # noqa: E402
from plslam_torch.models.map import SlamMap  # noqa: E402
from plslam_torch.models.tracking import Tracker  # noqa: E402
from plslam_torch.utils.synthetic import RoomScene  # noqa: E402
from torch_loop_scenario import anchor_err, orbit_poses, render_orbit  # noqa: E402
from torch_parity import KW  # noqa: E402

VOC = Path(__file__).resolve().parents[1] / "plslam_tpu" / "bow" / "vocab_synth.npz"


def kf_errs_cm(m, poses):
    """Each keyframe's KF0-relative error against ground truth, cm."""
    fid = m.kf_frame_id[:m.n_kf]
    gt_R = np.stack([poses[int(f)][0] for f in fid])
    gt_t = np.stack([poses[int(f)][1] for f in fid])
    return [round(100 * anchor_err(m.kf_R, m.kf_t, k, 0, gt_R, gt_t), 2) if m.kf_valid[k] else None
            for k in range(m.n_kf)]


def traj_errs_cm(traj, poses):
    """The tracked poses' error against the first frame, cm."""
    R = np.stack([np.asarray(r) for _, r, _ in traj])
    t = np.stack([np.asarray(x) for _, _, x in traj])
    gt_R = np.stack([p[0] for p in poses[:len(traj)]])
    gt_t = np.stack([p[1] for p in poses[:len(traj)]])
    return [round(100 * anchor_err(R, t, i, 0, gt_R, gt_t), 2) for i in range(len(traj))]


def record_corrections(cls, name, maps, poses, log):
    """Wraps ``cls._correct_loop`` to print the keyframe errors around it."""
    inner = cls._correct_loop

    def correct(self, kf1, kf2, R12, t12, s12=1.0):
        m = maps[name]
        before = kf_errs_cm(m, poses)
        out = inner(self, kf1, kf2, R12, t12, s12)
        log.append((name, kf1, kf2, before, kf_errs_cm(m, poses)))
        print(f"{name}: loop ({kf1}, {kf2}) at {m.n_kf} keyframes\n  before {before}\n"
              f"  after  {log[-1][4]}", flush=True)
        return out

    cls._correct_loop = correct
    return inner


def main(n, with_loop):
    torch.set_num_threads(4)
    poses = orbit_poses(150)[:n]
    jcfg = JSlamConfig(camera=JCamera(**KW), use_lines=True)
    jcfg = jcfg.replace(mapping=dataclasses.replace(jcfg.mapping, kf_culling_redundancy=10.0))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    frames = render_orbit(RoomScene(3), convert.Camera(**KW), poses,
                          cfg.tracking.depth_map_factor)

    jm = JSlamMap(jcfg)
    jvoc = JVocabulary.load(str(VOC))
    jdb = JKeyFrameDatabase(jvoc, max_kf=jcfg.capacity.max_keyframes)
    jlm = JLocalMapper(jcfg, jm, kfdb=jdb)
    jlc = jloop.LoopCloser(jcfg, jm, jdb, jvoc, local_mapper=jlm) if with_loop else None
    jt = JTracker(jcfg, jm, local_mapper=jlm, loop_closer=jlc, voc=jvoc, kfdb=jdb)
    m = SlamMap(cfg, device="cpu")
    voc = Vocabulary.load(device="cpu")
    db = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    lm = LocalMapper(cfg, m, kfdb=db)
    lc = tloop.LoopCloser(cfg, m, db, voc, local_mapper=lm) if with_loop else None
    tr = Tracker(cfg, m, local_mapper=lm, loop_closer=lc, voc=voc, kfdb=db)
    if with_loop:
        jlc.tracker, lc.tracker = jt, tr
    log = []
    maps = {"jax": jm, "port": m}
    saved = [record_corrections(jloop.LoopCloser, "jax", maps, poses, log),
             record_corrections(tloop.LoopCloser, "port", maps, poses, log)]
    try:
        for i, (g, d) in enumerate(frames):
            jt.process(g, d, i / 30.0)
            tr.process(g, d, i / 30.0)
        jt.flush()
        tr.flush()
    finally:
        jloop.LoopCloser._correct_loop, tloop.LoopCloser._correct_loop = saved
    for name, t, mm in (("jax", jt, jm), ("port", tr, m)):
        errs = kf_errs_cm(mm, poses)
        traj = traj_errs_cm(t.trajectory, poses)
        n_loops = sum(1 for e in log if e[0] == name)
        print(f"{name}: {len(t.trajectory)} frames tracked, {mm.n_kf} keyframes at frames "
              f"{[int(f) for f in mm.kf_frame_id[:mm.n_kf]]}, {n_loops} loops closed, "
              f"loop edges {list(mm.loop_edges)}")
        print(f"{name} keyframe KF0-relative errors, cm: {errs}; largest "
              f"{max(e for e in errs if e is not None)}")
        print(f"{name} tracked error every 10 frames, cm: {traj[::10]}; last {traj[-1]}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 150, "--no-loop" not in sys.argv)
