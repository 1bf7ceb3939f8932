"""The stereo and monocular e2e scenarios of tests/test_stereo.py and
tests/test_mono.py in both packages at 640x480 on the CPU (not a test
module): the "on par" yardstick for the port's phases stereo and mono.

    JAX_PLATFORMS=cpu python tests/torch_sensor_ate.py [jax|port ...]

Stereo: RoomScene(0), smooth_trajectory(50)[:25], Tracker(sensor="stereo")
with a synchronous LocalMapper; prints keyframes, rows and the ATE RMSE
(tum_io.ate_rmse, cm). Mono: smooth_trajectory(80)[:40],
Tracker(sensor="mono") with a synchronous LocalMapper; prints the
bootstrap frame, keyframes, points, rows and the similarity-aligned RMSE
(tests/test_mono.py::_sim_align, cm). Each package with its own RANSAC
draws, its BA as it ships.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_mono import _sim_align  # noqa: E402


def packages(name):
    if name == "jax":
        from plslam_tpu.config import SlamConfig
        from plslam_tpu.geometry.projection import Camera
        from plslam_tpu.models.local_mapping import LocalMapper
        from plslam_tpu.models.map import SlamMap
        from plslam_tpu.models.tracking import Tracker
        from plslam_tpu.utils import tum_io
        from plslam_tpu.utils.synthetic import RoomScene, smooth_trajectory
        new_map = SlamMap
    else:
        from plslam_torch.config import SlamConfig
        from plslam_torch.geometry.projection import Camera
        from plslam_torch.models.local_mapping import LocalMapper
        from plslam_torch.models.map import SlamMap
        from plslam_torch.models.tracking import Tracker
        from plslam_torch.utils import tum_io
        from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

        def new_map(cfg):
            return SlamMap(cfg, device="cpu")
    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    return cfg, new_map, LocalMapper, Tracker, tum_io, RoomScene, smooth_trajectory


def run(name):
    cfg, new_map, LocalMapper, Tracker, tum_io, RoomScene, smooth_trajectory = packages(name)
    scene = RoomScene(0)
    cam = cfg.camera
    # stereo
    n = 25
    poses = smooth_trajectory(2 * n)[:n]
    m = new_map(cfg)
    tr = Tracker(cfg, m, local_mapper=LocalMapper(cfg, m), sensor="stereo")
    t0 = time.perf_counter()
    for i, (R, t) in enumerate(poses):
        gl, _ = scene.render(cam, R, t)
        gr, _ = scene.render(cam, R, t - np.array([cam.bf / cam.fx, 0, 0], np.float32))
        tr.process_stereo(np.clip(gl, 0, 255).astype(np.uint8),
                          np.clip(gr, 0, 255).astype(np.uint8), i / 30.0)
    tr.flush()
    ts = np.array([s for s, _, _ in tr.trajectory])
    est = np.array([-R.T @ t for _, R, t in tr.trajectory])
    gt = np.array([-R.T @ t for R, t in poses])
    ate = tum_io.ate_rmse(ts, est, np.arange(n) / 30.0, gt)
    print(f"{name} stereo: state {tr.state}, keyframes {m.n_kf}, points {m.n_points()}, "
          f"rows {len(est)}, ATE RMSE {ate * 100:.4f} cm, {time.perf_counter() - t0:.1f} s",
          flush=True)
    # mono
    n = 40
    poses = smooth_trajectory(2 * n)[:n]
    m = new_map(cfg)
    tr = Tracker(cfg, m, local_mapper=LocalMapper(cfg, m), sensor="mono")
    t0 = time.perf_counter()
    boot = None
    for i, (R, t) in enumerate(poses):
        g, _ = scene.render(cam, R, t)
        tr.process_mono(g, i / 30.0)
        if boot is None and tr.state == 1:
            boot = i
    tr.flush()
    ts = np.array([s for s, _, _ in tr.trajectory])
    est = np.array([-R.T @ t for _, R, t in tr.trajectory])
    idx = np.clip((ts * 30).round().astype(int), 0, n - 1)
    gt = np.array([-poses[i][0].T @ poses[i][1] for i in idx])
    print(f"{name} mono: state {tr.state}, bootstrap frame {boot}, keyframes {m.n_kf}, "
          f"points {m.n_points()}, rows {len(est)}, similarity RMSE "
          f"{_sim_align(est, gt) * 100:.4f} cm, {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    import conftest  # noqa: F401  (the JAX package on the CPU)

    for name in sys.argv[1:] or ["jax", "port"]:
        run(name)
