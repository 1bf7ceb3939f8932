"""The localization-only leg of ``chip_smoke.py`` phase ``reloc`` on the
CPU at 320x240, in both packages (not a test module):

    JAX_PLATFORMS=cpu python tests/torch_vo_leg.py

Maps 60 frames of the orbit of tests/test_loop_closing.py in room 3 with a
synchronous local mapper, a vocabulary and a keyframe database (no lines),
erases the landmarks anchored in the middle band of keyframes (at most one
observer outside it, as tests/test_vo_mode.py), switches to
localization-only tracking with local BA off and replays frames 2..57.
Prints per package: keyframes, points erased, the frames tracked in VO
mode, whether any frame was LOST, the final state and the final camera
centre's distance from ground truth. About 3 minutes.
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plslam_tpu.bow.database import KeyFrameDatabase as JKeyFrameDatabase  # noqa: E402
from plslam_tpu.bow.vocabulary import Vocabulary as JVocabulary  # noqa: E402
from plslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from plslam_tpu.geometry.projection import Camera as JCamera  # noqa: E402
from plslam_tpu.models import tracking as jtracking  # noqa: E402
from plslam_tpu.models.local_mapping import LocalMapper as JLocalMapper  # noqa: E402
from plslam_tpu.models.map import SlamMap as JSlamMap  # noqa: E402
from plslam_torch import convert  # noqa: E402
from plslam_torch.bow.database import KeyFrameDatabase  # noqa: E402
from plslam_torch.bow.vocabulary import Vocabulary  # noqa: E402
from plslam_torch.models import tracking as ttracking  # noqa: E402
from plslam_torch.models.local_mapping import LocalMapper  # noqa: E402
from plslam_torch.models.map import SlamMap  # noqa: E402
from plslam_torch.utils.synthetic import RoomScene  # noqa: E402

import chip_smoke  # noqa: E402

KW = dict(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=40.0, width=320, height=240)
VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "plslam_" + "tpu", "bow", "vocab_synth.npz")


def leg(tracker, mapper, frames, poses, n_map=60):
    m = tracker.map
    for i, (g, d) in enumerate(frames):
        tracker.process(g, d, i / 30.0)
    tracker.flush()
    n_kf = m.n_kf
    band = set(range(n_kf // 3, 2 * n_kf // 3 + 1))
    erased = 0
    for pid in m.point_ids():
        obs = m.pt_obs[pid]
        nb = sum(1 for k in obs if k in band)
        if obs and nb > 0 and len(obs) - nb <= 1:
            m.erase_point(pid)
            erased += 1
    tracker.only_tracking = True
    mapper.enable_ba = False
    tracker._refresh_local_map(tracker.last_pt_ids, tracker.last_ln_ids)
    states, vo = [], []
    for j, i in enumerate(range(2, n_map - 2)):
        tracker.process(*frames[i], (n_map + j) / 30.0)
        states.append(tracker.state)
        if tracker.vo_mode:
            vo.append(i)
    tracker.flush()
    err = chip_smoke._gauge_error(tracker.last_pose, poses, n_map - 3)
    return dict(keyframes=n_kf, keyframes_after=m.n_kf, erased=erased, vo_frames=vo,
                lost=ttracking.LOST in states, state=tracker.state,
                vo_mode_at_end=tracker.vo_mode, final_error_cm=round(err * 100, 4))


def main():
    jcfg = JSlamConfig(camera=JCamera(**KW), use_lines=False)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    poses = chip_smoke.orbit_poses(150)
    scene = RoomScene(3)
    f = cfg.tracking.depth_map_factor
    frames = [chip_smoke._render(scene, cfg.camera, p, f) for p in poses[:60]]

    jvoc = JVocabulary.load(VOC)
    jm = JSlamMap(jcfg)
    jdb = JKeyFrameDatabase(jvoc, max_kf=jcfg.capacity.max_keyframes)
    jmapper = JLocalMapper(jcfg, jm, kfdb=jdb)
    t0 = time.time()
    out = leg(jtracking.Tracker(jcfg, jm, local_mapper=jmapper, voc=jvoc, kfdb=jdb),
              jmapper, frames, poses)
    print("JAX package", out, f"{time.time() - t0:.1f} s", flush=True)

    voc = Vocabulary.load(device="cpu")
    m = SlamMap(cfg, device="cpu")
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    mapper = LocalMapper(cfg, m, kfdb=kfdb)
    t0 = time.time()
    out = leg(ttracking.Tracker(cfg, m, local_mapper=mapper, voc=voc, kfdb=kfdb), mapper,
              frames, poses)
    print("port", out, f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
