"""The severed-map loop of chip_smoke.py's phase loop on one map in both
packages on the CPU (not a test module).

    JAX_PLATFORMS=cpu python tests/torch_sever_replay.py MAP.npz [--small]

MAP.npz is the final map of an orbit of RoomScene(3) saved by ``python -m
plslam_torch.utils.orbit_probe --dump-end`` (JAX checkpoint layout, with
each keyframe's orbit frame). For each case the map is loaded afresh into
the JAX package or carried into the port, every keyframe is registered in
a new keyframe database, the old half (keyframes < n_kf // 2) is severed
and displaced by yaw 0.10 rad and t = (0.15, 0, -0.12)
(tests/test_loop_closing.py::sever_and_displace), and a synchronous
``LoopCloser`` gets the newest keyframe up to 3 times. The cases: each
package with loop edges across the cut kept (the JAX helper) and dropped
(tests/torch_loop_scenario.py's helper, as phase loop severs). Prints per
case the loop pair, the anchor error against ground truth before and after
the correction (cm), cross-sector landmarks, and every keyframe's
KF0-relative camera-centre error after it (cm).
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
from plslam_tpu.utils import checkpoint  # noqa: E402
from plslam_torch import convert  # noqa: E402
from plslam_torch.bow.database import KeyFrameDatabase  # noqa: E402
from plslam_torch.bow.vocabulary import Vocabulary, sparse_bow  # noqa: E402
from plslam_torch.models import loop_closing as tloop  # noqa: E402
from plslam_torch.models.local_mapping import LocalMapper  # noqa: E402
from plslam_torch.utils.orbit_probe import orbit_poses  # noqa: E402
from test_loop_closing import sever_and_displace as jax_sever  # noqa: E402
from torch_loop_replay import kf_errs  # noqa: E402
from torch_loop_scenario import W_R, W_t, anchor_err  # noqa: E402
from torch_loop_scenario import sever_and_displace as port_sever  # noqa: E402
from torch_parity import KW, map_arrays  # noqa: E402

VOC = Path(__file__).resolve().parents[1] / "plslam_tpu" / "bow" / "vocab_synth.npz"


def jax_closer(jcfg, path):
    jm = checkpoint.load_map(jcfg, path)
    voc = JVocabulary.load(str(VOC))
    db = JKeyFrameDatabase(voc, max_kf=jcfg.capacity.max_keyframes)
    for k in range(jm.n_kf):
        if jm.kf_valid[k]:
            fd = jm.device_frame(k)
            db.add(k, np.asarray(voc.transform(fd.kp_desc, fd.kp_valid)[1]))
    return jm, jloop.LoopCloser(jcfg, jm, db, voc, local_mapper=JLocalMapper(jcfg, jm, kfdb=db))


def port_closer(jcfg, cfg, path):
    m = convert.map_from_numpy(map_arrays(checkpoint.load_map(jcfg, path)), cfg, device="cpu")
    voc = Vocabulary.load(device="cpu")
    db = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    for k in range(m.n_kf):
        if m.kf_valid[k]:
            fd = m.device_frame(k)
            db.add(k, sparse_bow(voc.transform(fd.kp_desc, fd.kp_valid)[1]))
    return m, tloop.LoopCloser(cfg, m, db, voc, local_mapper=LocalMapper(cfg, m, kfdb=db))


def run_case(name, m, lc, keep_edges, of, poses):
    kf_cut = max(m.n_kf // 2, 1)
    if name == "jax":
        jax_sever(m, None, kf_cut, W_R, W_t)
        if not keep_edges:
            m.loop_edges = [(a, b) for a, b in m.loop_edges if (a < kf_cut) == (b < kf_cut)]
    else:
        port_sever(m, kf_cut, W_R, W_t, drop_loop_edges=not keep_edges)
    K = m.n_kf
    gt_R = np.stack([poses[f][0] for f in of])
    gt_t = np.stack([poses[f][1] for f in of])
    disp_R, disp_t = m.kf_R[:K].copy(), m.kf_t[:K].copy()
    k = max(q for q in range(K) if m.kf_valid[q])
    for _ in range(3):
        lc.process_keyframe(k)
        if lc.n_loops_closed:
            break
    line = f"{name}, loop edges across the cut {'kept' if keep_edges else 'dropped'}: "
    if not lc.n_loops_closed:
        print(line + "no loop closed", flush=True)
        return
    k1, k2 = lc.last_loop_pair
    cross = sum(1 for pid in m.point_ids()
                if any(q < kf_cut for q in m.pt_obs[pid]) and any(q >= kf_cut for q in m.pt_obs[pid]))
    errs = kf_errs(m.kf_R, m.kf_t, of, poses, m.kf_valid)
    print(line + f"loop ({k1}, {k2}), cut {kf_cut}, anchor "
          f"{100 * anchor_err(disp_R, disp_t, k2, k1, gt_R, gt_t):.2f} -> "
          f"{100 * anchor_err(m.kf_R, m.kf_t, k2, k1, gt_R, gt_t):.2f} cm, {cross} cross-sector "
          f"landmarks, largest keyframe error {max(errs.values())} cm\n  {errs}", flush=True)


def main(path, small):
    torch.set_num_threads(4)
    z = np.load(path)
    cam = JCamera(**KW) if small else JCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)
    jcfg = JSlamConfig(camera=cam, use_lines=True)
    jcfg = jcfg.replace(mapping=dataclasses.replace(jcfg.mapping, kf_culling_redundancy=10.0))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    of = [int(f) for f in z["kf_orbit_frame"]]
    poses = orbit_poses(150)
    print(f"map: {len(of)} keyframes, loop edges {z['loop_edges'].tolist()}, before severance "
          f"{kf_errs(z['kf_R'], z['kf_t'], of, poses, z['kf_valid'])}", flush=True)
    for keep in (True, False):
        run_case("jax", *jax_closer(jcfg, path), keep, of, poses)
        run_case("port", *port_closer(jcfg, cfg, path), keep, of, poses)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(args[0], "--small" in sys.argv)
