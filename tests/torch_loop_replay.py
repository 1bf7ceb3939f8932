"""Replay one loop correction in both packages on the CPU (not a test
module).

    JAX_PLATFORMS=cpu python tests/torch_loop_replay.py MAP.npz [--small] [--jax-f64]

MAP.npz is a map saved by ``python -m plslam_torch.utils.orbit_probe`` just
before a live loop correction on the orbit of RoomScene(3), in the JAX
package's checkpoint layout, with the correction's arguments (kf1, kf2,
R12, t12) and each keyframe's orbit frame. The map is loaded into the JAX
package (``plslam_tpu.utils.checkpoint.load_map``) and carried into the port
with ``convert.map_from_numpy``; each package's ``LoopCloser._correct_loop``
then runs on it with a synchronous ``LocalMapper`` (propagation,
SearchAndFuse, essential graph, global BA). Prints every keyframe's
KF0-relative camera-centre error against ground truth (cm) before the
correction and after it in each package, and after each stage the largest
keyframe centre difference between the packages. ``--small``: the map was
made at 320x240. ``--jax-f64``: the JAX package's BA solves in float64, as
the port's does.
"""

import contextlib
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
from plslam_torch.bow.vocabulary import Vocabulary  # noqa: E402
from plslam_torch.models import loop_closing as tloop  # noqa: E402
from plslam_torch.models.local_mapping import LocalMapper  # noqa: E402
from plslam_torch.utils.orbit_probe import centre_err, orbit_poses  # noqa: E402
from torch_parity import KW, jax_ba_in_float64, map_arrays  # noqa: E402

VOC = Path(__file__).resolve().parents[1] / "plslam_tpu" / "bow" / "vocab_synth.npz"


def kf_errs(R, t, orbit_frame, poses, valid):
    g0 = poses[orbit_frame[0]]
    return {k: round(100 * centre_err(R[k], t[k], R[0], t[0], *poses[orbit_frame[k]], *g0), 2)
            for k in range(len(orbit_frame)) if valid[k] and orbit_frame[k] >= 0}


STAGES = ("_propagate_group", "_search_and_fuse", "_optimize_essential_graph", "_global_ba")


def record_stages(lc, m):
    """Keyframe poses and landmark count after each stage of ``lc``."""
    snaps = {}
    for name in STAGES:
        def run(*a, _fn=getattr(lc, name), _name=name, **kw):
            out = _fn(*a, **kw)
            snaps[_name] = (m.kf_R.copy(), m.kf_t.copy(), m.n_points())
            return out
        setattr(lc, name, run)
    return snaps


def centres(R, t, K):
    return np.einsum("kji,kj->ki", R[:K], -t[:K])


def main(path, small, jax_f64):
    torch.set_num_threads(4)
    z = np.load(path)
    cam = JCamera(**KW) if small else JCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)
    jcfg = JSlamConfig(camera=cam, use_lines=True)
    jcfg = jcfg.replace(mapping=dataclasses.replace(jcfg.mapping, kf_culling_redundancy=10.0))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    kf1, kf2 = int(z["kf1"]), int(z["kf2"])
    R12, t12 = z["R12"], z["t12"]
    of = [int(f) for f in z["kf_orbit_frame"]]
    poses = orbit_poses(150)
    K = len(of)

    jm = checkpoint.load_map(jcfg, path)
    m = convert.map_from_numpy(map_arrays(jm), cfg, device="cpu")
    print(f"map: {K} keyframes, {jm.n_points()} points, {jm.n_lines()} lines, loop ({kf1}, {kf2}),"
          f" loop edges {list(jm.loop_edges)}")
    print(f"before: {kf_errs(jm.kf_R, jm.kf_t, of, poses, jm.kf_valid)}", flush=True)

    jvoc = JVocabulary.load(str(VOC))
    jdb = JKeyFrameDatabase(jvoc, max_kf=jcfg.capacity.max_keyframes)
    jlc = jloop.LoopCloser(jcfg, jm, jdb, jvoc, local_mapper=JLocalMapper(jcfg, jm, kfdb=jdb))
    jsnaps = record_stages(jlc, jm)
    with jax_ba_in_float64() if jax_f64 else contextlib.nullcontext():
        jlc._correct_loop(kf1, kf2, R12, t12)
    print(f"after, JAX:  {kf_errs(jm.kf_R, jm.kf_t, of, poses, jm.kf_valid)}", flush=True)

    voc = Vocabulary.load(device="cpu")
    db = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    lc = tloop.LoopCloser(cfg, m, db, voc, local_mapper=LocalMapper(cfg, m, kfdb=db))
    snaps = record_stages(lc, m)
    lc._correct_loop(kf1, kf2, R12, t12)
    print(f"after, port: {kf_errs(m.kf_R, m.kf_t, of, poses, m.kf_valid)}")
    for name in STAGES:
        (jR, jt, jn), (tR, tt, tn) = jsnaps[name], snaps[name]
        gap = np.linalg.norm(centres(jR, jt, K) - centres(tR, tt, K), axis=1)[m.kf_valid[:K]]
        print(f"after {name.lstrip('_')}: largest keyframe centre difference between the "
              f"packages {100 * gap.max():.3f} cm; landmarks {jn} (JAX), {tn} (port); "
              f"largest keyframe error {max(kf_errs(jR, jt, of, poses, m.kf_valid).values())} "
              f"(JAX), {max(kf_errs(tR, tt, of, poses, m.kf_valid).values())} (port) cm")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(args[0], "--small" in sys.argv, "--jax-f64" in sys.argv)
